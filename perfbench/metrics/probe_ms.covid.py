"""Device time of the kernels launched inside the program's span
``engine.probe`` in the TREC-COVID cell (cascade stages 1-2 over 65,536
cells), ms a call, read as ``probe_ms.batch`` reads it. Layer: engine
torch ops (``search/engine.py``)."""

from perfbench.harness import metric_reader

read = metric_reader("probe_ms.batch")
