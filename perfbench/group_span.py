"""The dedup wrapper's span ``rerank.group`` (``ops/rerank_dedup.py``) under
a name that ``spans.PREFIXES`` takes as a program span, so that
``spans.device_ms`` can give its kernels to it and not to ``engine.rerank``.
A record without the span (a program that lacks it) is returned unchanged
in content."""

from __future__ import annotations

__all__ = ["GROUP", "ALIAS", "aliased"]

GROUP = "rerank.group"
ALIAS = "engine.rerank.group"


def aliased(rec: dict) -> dict:
    """``rec`` with every ``rerank.group`` renamed ``engine.rerank.group``."""
    out = dict(rec)
    out["host_ops"] = [(ALIAS if name == GROUP else name, ts, dur) for name, ts, dur in rec["host_ops"]]
    if "launch_span" in rec:
        out["launch_span"] = [(*e[:4], ALIAS if e[4] == GROUP else e[4]) for e in rec["launch_span"]]
    return out
