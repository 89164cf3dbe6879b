"""Metadata filtering parity: the port's ``filtering`` against the JAX
package's.

The same create / update (with a new column) / delete / get / where / date /
injection sequence through both packages gives the same rows, and each
package reads the other's ``metadata.db``. The port binds and parses dates
itself: its calls run with warnings as errors (Python 3.12 deprecates
sqlite3's default date adapters), and the bytes it stores equal the JAX
package's.
"""

from __future__ import annotations

import datetime
import sqlite3
import warnings

import pytest

from fast_plaid_tpu import filtering as jfilt
from fast_plaid_tpu_torch import filtering as tfilt

ROWS = [
    {"cat": "a", "price": 10, "when": datetime.date(2020, 1, 1), "ok": True},
    {"cat": "b", "price": 25.5, "when": datetime.date(2021, 2, 2), "ok": False},
    {"cat": None, "price": 5, "when": None, "at": datetime.datetime(2022, 3, 3, 4, 5, 6, 7)},
    {"cat": "b", "price": 50, "when": datetime.date(2023, 4, 4), "blob": b"\x00\x01"},
    {"cat": "c", "price": 30, "when": datetime.date(2024, 5, 5)},
] * 3
MORE = [{"cat": "z", "price": 1, "extra": "new column"}, {"cat": "a", "when": datetime.date(2025, 6, 6)}]


def _strict(fn, *args, **kwargs):
    """Run a port call with every warning an error."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return fn(*args, **kwargs)


def _jax(fn, *args, **kwargs):
    """Run a JAX-package call, which uses sqlite3's deprecated default date
    adapters."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kwargs)


def _sequence(mod, call, path):
    """create -> update (new column) -> delete -> reads."""
    call(mod.create, index=path, metadata=ROWS)
    call(mod.update, index=path, metadata=MORE)
    call(mod.delete, index=path, subset=[1, 4, 9])
    return {
        "all": call(mod.get, index=path),
        "subset": call(mod.get, index=path, subset=[3, 0, 3, 100]),
        "cond": call(mod.get, index=path, condition="price > ?", parameters=(20,)),
        "where": call(mod.where, path, "cat = ?", ("b",)),
        "where_date": call(mod.where, path, "\"when\" >= ?", (datetime.date(2023, 1, 1),)),
        "where_null": call(mod.where, path, "cat IS NULL"),
    }


def _table_bytes(path):
    conn = sqlite3.connect(f"{path}/metadata.db")
    try:
        schema = conn.execute("SELECT sql FROM sqlite_master WHERE name = 'metadata'").fetchone()
        rows = conn.execute(
            "SELECT *, typeof(\"when\") FROM metadata ORDER BY _subset_"
        ).fetchall()
        return schema, rows
    finally:
        conn.close()


def test_sequence_matches_jax(tmp_path):
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    want = _sequence(jfilt, _jax, pj)
    got = _sequence(tfilt, _strict, pt)
    assert got == want
    assert got["all"][0]["when"] == datetime.date(2020, 1, 1)
    assert [r["_subset_"] for r in got["all"]] == list(range(len(ROWS) + len(MORE) - 3))
    assert got["where_date"] and got["where_null"]


def test_stored_bytes_match_jax(tmp_path):
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    _sequence(jfilt, _jax, pj)
    _sequence(tfilt, _strict, pt)
    assert _table_bytes(pt) == _table_bytes(pj)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_read(tmp_path, writer):
    """Each package reads the other's database alike, dates included."""
    path = str(tmp_path / writer)
    if writer == "jax":
        _sequence(jfilt, _jax, path)
    else:
        _sequence(tfilt, _strict, path)
    got = _strict(tfilt.get, index=path)
    want = _jax(jfilt.get, index=path)
    assert got == want
    assert any(isinstance(r.get("at"), datetime.datetime) for r in got)
    assert _strict(tfilt.where, path, "price > ?", (20,)) == _jax(jfilt.where, path, "price > ?", (20,))


def test_errors_match(tmp_path):
    for mod, call in ((jfilt, _jax), (tfilt, _strict)):
        path = str(tmp_path / mod.__name__.split(".")[0])
        with pytest.raises(ValueError):
            call(mod.create, index=path, metadata=[{"a; DROP TABLE x": 1}])
        call(mod.create, index=path, metadata=[{"a": i} for i in range(5)])
        with pytest.raises(ValueError):
            call(mod.delete, index=path, subset=[3, 1])
        with pytest.raises(TypeError):
            call(mod.delete, index=path, subset=[1.5])
        with pytest.raises(FileNotFoundError):
            call(mod.where, str(tmp_path / "none"), "a = 1")
        with pytest.raises(FileNotFoundError):
            call(mod.get, index=str(tmp_path / "none"))
        assert call(mod.get, index=path, subset=[]) == []
