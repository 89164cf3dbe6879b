"""Time the search thread waits for the host row gather of low_memory's
pipeline: the program's span ``search.gather_wait``, ms a call; the part of
the gather that the pipeline does not hide. Layer: host row gather
(``searcher.host_gather_rows``)."""

from perfbench.spans import span_ms


def read(rec):
    return span_ms(rec, ("search.gather_wait",))
