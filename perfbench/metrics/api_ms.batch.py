"""Host time of a search call with no device work of the call: entry to its
first device operation, plus its last device operation to the return (ms a
call). Layer: API and host driver (``search/fast_plaid.py``,
``search/searcher.py``)."""


def read(rec):
    ops = rec["device_ops"]
    total, n = 0.0, 0
    for lo, hi in rec["calls"]:
        inside = [(ts, ts + dur) for _, ts, dur, _ in ops if ts >= lo and ts + dur <= hi]
        if not inside:
            continue
        total += (min(s for s, _ in inside) - lo) + (hi - max(e for _, e in inside))
        n += 1
    return total / n / 1e3 if n else None
