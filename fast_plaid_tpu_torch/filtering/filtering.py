"""SQLite-backed metadata store for subset filtering.

A copy of ``fast_plaid_tpu/filtering/filtering.py`` (importing that module
runs ``fast_plaid_tpu/__init__.py``, which imports jax). One ``metadata``
table in ``<index>/metadata.db`` keyed by ``_subset_`` INTEGER PRIMARY KEY
equal to document insertion order; ``where()`` returns ``_subset_`` ids that
feed ``FastPlaid.search(subset=...)``.

* ``create`` drops and rebuilds the table,
* ``update`` appends rows, ALTERing new columns in,
* ``delete`` removes rows then re-sequences ``_subset_`` from 0,
* ``get`` orders by the given subset list (with duplicates) or by
  ``_subset_`` ascending,
* identifier names are validated against injection and values bind through
  '?' placeholders.

Dates and datetimes are stored as the ISO strings Python's default sqlite3
adapters write (``date.isoformat()``, ``datetime.isoformat(" ")``), in
columns declared ``date`` / ``timestamp``, and read back into ``date`` /
``datetime`` from the declared column type. The conversion is explicit here:
the default adapters and converters are deprecated since Python 3.12, and
registering replacements would change them for every sqlite3 user in the
process. The database is byte-compatible with the JAX package's.
"""

from __future__ import annotations

import datetime
import os
import re
import sqlite3
from typing import Any

__all__ = ["create", "update", "delete", "get", "where"]

_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _check_identifier(name: str) -> str:
    if not _IDENT_RE.match(name):
        msg = f"Invalid column name: {name!r}"
        raise ValueError(msg)
    return name


def _sql_type(value: Any) -> str:
    if isinstance(value, bool):
        return "INTEGER"
    if isinstance(value, int):
        return "INTEGER"
    if isinstance(value, float):
        return "REAL"
    if isinstance(value, datetime.datetime):
        return "timestamp"
    if isinstance(value, datetime.date):
        return "date"
    if isinstance(value, bytes):
        return "BLOB"
    return "TEXT"


def _bind(value: Any) -> Any:
    """A value as sqlite3 stores it, dates and datetimes as ISO strings."""
    if isinstance(value, datetime.datetime):
        return value.isoformat(" ")
    if isinstance(value, datetime.date):
        return value.isoformat()
    return value


def _bind_all(parameters) -> Any:
    if isinstance(parameters, dict):
        return {k: _bind(v) for k, v in parameters.items()}
    return [_bind(v) for v in parameters]


_PARSERS = {
    "date": datetime.date.fromisoformat,
    "timestamp": datetime.datetime.fromisoformat,
}


def _parsers(cursor: sqlite3.Cursor) -> dict[str, Any]:
    """{column: parser} for the columns declared ``date`` or ``timestamp``."""
    cursor.execute("PRAGMA table_info(metadata)")
    out = {}
    for row in cursor.fetchall():
        decl = (row[2] or "").split()
        parse = _PARSERS.get(decl[0].lower()) if decl else None
        if parse is not None:
            out[row[1]] = parse
    return out


def _parse_row(row: dict[str, Any], parsers: dict[str, Any]) -> dict[str, Any]:
    for name, parse in parsers.items():
        if isinstance(row.get(name), str):
            row[name] = parse(row[name])
    return row


def _db_path(index: str) -> str:
    return os.path.join(index, "metadata.db")


def _connect(index: str) -> sqlite3.Connection:
    return sqlite3.connect(_db_path(index))


def _collect_columns(metadata: list[dict[str, Any]]) -> dict[str, str]:
    """Ordered {column: sql type}, type inferred from the first non-None value."""
    columns: dict[str, str] = {}
    for row in metadata:
        for key, value in row.items():
            _check_identifier(key)
            if key not in columns or columns[key] == "TEXT" and value is not None:
                if value is not None:
                    columns[key] = _sql_type(value)
                else:
                    columns.setdefault(key, "TEXT")
    return columns


def create(index: str, metadata: list[dict[str, Any]]) -> None:
    """Create (or replace) the metadata database with the given rows."""
    os.makedirs(index, exist_ok=True)
    conn = _connect(index)
    try:
        cursor = conn.cursor()
        cursor.execute("DROP TABLE IF EXISTS metadata")
        columns = _collect_columns(metadata)
        col_defs = ", ".join(
            ["_subset_ INTEGER PRIMARY KEY"]
            + [f'"{name}" {typ}' for name, typ in columns.items()]
        )
        cursor.execute(f"CREATE TABLE metadata ({col_defs})")
        _insert_rows(cursor, list(columns), metadata, start_id=0)
        conn.commit()
    finally:
        conn.close()
    print(f"Database created at '{_db_path(index)}' with {len(metadata)} rows.")


def _insert_rows(
    cursor: sqlite3.Cursor,
    columns: list[str],
    metadata: list[dict[str, Any]],
    start_id: int,
) -> None:
    names = ", ".join(["_subset_"] + [f'"{c}"' for c in columns])
    holes = ", ".join(["?"] * (len(columns) + 1))
    rows = [
        tuple([start_id + i] + [_bind(row.get(c)) for c in columns])
        for i, row in enumerate(metadata)
    ]
    cursor.executemany(
        f"INSERT INTO metadata ({names}) VALUES ({holes})", rows  # noqa: S608
    )


def _existing_columns(cursor: sqlite3.Cursor) -> list[str]:
    cursor.execute("PRAGMA table_info(metadata)")
    return [r[1] for r in cursor.fetchall() if r[1] != "_subset_"]


def update(index: str, metadata: list[dict[str, Any]]) -> None:
    """Append rows, ALTERing the table when new columns appear."""
    if not metadata:
        print("No metadata provided to update.")
        return
    path = _db_path(index)
    if not os.path.exists(path):
        create(index, metadata)
        return
    conn = _connect(index)
    try:
        cursor = conn.cursor()
        existing = _existing_columns(cursor)
        new_cols = _collect_columns(metadata)
        for name, typ in new_cols.items():
            if name not in existing:
                cursor.execute(f'ALTER TABLE metadata ADD COLUMN "{name}" {typ}')
                existing.append(name)
        cursor.execute("SELECT COALESCE(MAX(_subset_) + 1, 0) FROM metadata")
        start_id = int(cursor.fetchone()[0])
        _insert_rows(cursor, existing, metadata, start_id=start_id)
        conn.commit()
    finally:
        conn.close()


def delete(index: str, subset: list[int] | int) -> None:
    """Delete rows and re-sequence ``_subset_`` to 0..n-1 (insertion order)."""
    if isinstance(subset, int):
        subset = [subset]
    if not all(isinstance(i, int) for i in subset):
        msg = "All elements in the 'subset' list must be integers."
        raise TypeError(msg)
    if any(subset[i] > subset[i + 1] for i in range(len(subset) - 1)):
        msg = "The 'subset' list of IDs to delete must be sorted in ascending order."
        raise ValueError(msg)
    if not subset:
        return
    conn = _connect(index)
    try:
        cursor = conn.cursor()
        try:
            holes = ", ".join("?" * len(subset))
            cursor.execute(
                f"DELETE FROM metadata WHERE _subset_ IN ({holes})",  # noqa: S608
                subset,
            )
            # Re-sequence _subset_ preserving order.
            cursor.execute("SELECT _subset_ FROM metadata ORDER BY _subset_")
            remaining = [r[0] for r in cursor.fetchall()]
            for new_id, old_id in enumerate(remaining):
                if new_id != old_id:
                    cursor.execute(
                        "UPDATE metadata SET _subset_ = ? WHERE _subset_ = ?",
                        (new_id, old_id),
                    )
            conn.commit()
            print(f"Deleted {len(subset)} rows and re-indexed '_subset_'.")
        except Exception:
            conn.rollback()
            raise
    finally:
        conn.close()


def get(
    index: str,
    condition: str | None = None,
    parameters: tuple | list = (),
    subset: list[int] | None = None,
) -> list[dict[str, Any]]:
    """Fetch rows as dicts, ordered by ``subset`` (with duplicates) or id."""
    path = _db_path(index)
    if not os.path.exists(path):
        msg = "No metadata database found. Please create it first."
        raise FileNotFoundError(msg)
    conn = _connect(index)
    try:
        conn.row_factory = sqlite3.Row
        cursor = conn.cursor()
        parsers = _parsers(cursor)
        if subset is not None:
            if not subset:
                return []
            holes = ", ".join("?" * len(subset))
            cursor.execute(
                f"SELECT * FROM metadata WHERE _subset_ IN ({holes})",  # noqa: S608
                list(subset),
            )
            by_id = {
                row["_subset_"]: _parse_row(dict(row), parsers)
                for row in cursor.fetchall()
            }
            return [by_id[i] for i in subset if i in by_id]
        if condition is not None:
            cursor.execute(
                f"SELECT * FROM metadata WHERE {condition} "  # noqa: S608
                "ORDER BY _subset_",
                _bind_all(parameters),
            )
        else:
            cursor.execute("SELECT * FROM metadata ORDER BY _subset_")
        return [_parse_row(dict(row), parsers) for row in cursor.fetchall()]
    finally:
        conn.close()


def where(index: str, condition: str, parameters: tuple | list = ()) -> list[int]:
    """Return ``_subset_`` ids matching a SQL condition (feeds search subset)."""
    path = _db_path(index)
    if not os.path.exists(path):
        msg = (
            "No metadata database found. Please create it first by "
            "adding metadata during index creation."
        )
        raise FileNotFoundError(msg)
    conn = _connect(index)
    try:
        cursor = conn.cursor()
        cursor.execute(
            f"SELECT _subset_ FROM metadata WHERE {condition}",  # noqa: S608
            _bind_all(parameters),
        )
        return [row[0] for row in cursor.fetchall()]
    finally:
        conn.close()
