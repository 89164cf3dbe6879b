"""Device time of the kernels launched inside the program's span
``engine.probe`` (cascade stages 1-2: query-centroid scores and the IVF
probe's top-k), ms a call. Layer: engine torch ops (``search/engine.py``)."""

from perfbench.spans import device_ms


def read(rec):
    return device_ms(rec, ("engine.probe",))
