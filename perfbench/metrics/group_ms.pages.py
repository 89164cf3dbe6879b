"""Device time of the dedup wrapper's grouping a search call: the kernels
launched inside the program's span ``rerank.group`` (the pool's sort, the
entries' bounds and casts), ms a call; None where the program has no such
span. Layer: stage 6 kernels (``ops/rerank_dedup.py``)."""

from perfbench.group_span import ALIAS, aliased
from perfbench.spans import device_ms


def read(rec):
    return device_ms(aliased(rec), (ALIAS,))
