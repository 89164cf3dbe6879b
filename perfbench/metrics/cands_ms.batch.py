"""Device time of the kernels launched inside the program's spans
``engine.candidates`` and ``engine.prune`` (cascade stages 3 and 5: probed
cells to IVF windows and candidate slots, and the top-k down to the rerank
pool), ms a call. Layer: engine torch ops (``search/engine.py``)."""

from perfbench.spans import device_ms


def read(rec):
    return device_ms(rec, ("engine.candidates", "engine.prune"))
