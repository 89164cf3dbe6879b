"""Device time a search call of every kernel that is not one of the four
named CUDA kernels (ms). Layer: engine torch ops (``search/engine.py``)."""


def read(rec):
    named = [n for names in rec["kernels"].values() for n in names]
    kernels = [(name, dur) for name, _, dur, cat in rec["device_ops"] if cat == "kernel"]
    if not rec["calls"] or not kernels:
        return None
    total = sum(dur for name, dur in kernels if not any(k in name for k in named))
    return total / len(rec["calls"]) / 1e3
