"""Device time of stage 6 a search call: the kernels launched inside the
program's span ``engine.rerank`` and its child ``rerank.group`` (the dedup
wrapper's sort and entry build, then kernel #4), ms a call. Layer: stage 6
kernels (``ops/rerank_dedup.py``)."""

from perfbench.group_span import ALIAS, aliased
from perfbench.spans import device_ms


def read(rec):
    return device_ms(aliased(rec), ("engine.rerank", ALIAS))
