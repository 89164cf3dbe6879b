"""Share of the traced calls' span in which no device operation ran (%).
Layer: device."""

from perfbench.tracing import busy_intervals


def read(rec):
    if not rec["calls"] or not rec["device_ops"]:
        return None
    span = rec["calls"][-1][1] - rec["calls"][0][0]
    busy = sum(e - s for s, e in busy_intervals(rec))
    return 100.0 * (1.0 - busy / span) if span > 0 else None
