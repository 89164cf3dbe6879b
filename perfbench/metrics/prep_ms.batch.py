"""Host time of a search call before its first tile: the program's spans
``search.prepare`` (reload check, query and subset normalisation) and
``search.plan`` (query checks and padding, the candidate policies, the tile
size), ms a call. Layer: API and host driver (``search/fast_plaid.py``,
``search/searcher.py``)."""

from perfbench.spans import span_ms


def read(rec):
    return span_ms(rec, ("search.prepare", "search.plan"))
