"""Device time of stage 6 a search call in the TREC-COVID cell: the kernels
launched inside ``engine.rerank`` and its child ``rerank.group`` (the dedup
wrapper's sort and entry build, then kernel #4 at D 96), ms a call, read
as ``rerank_ms.pages`` reads it. Layer: stage 6 kernels
(``ops/rerank_dedup.py``)."""

from perfbench.harness import metric_reader

read = metric_reader("rerank_ms.pages")
