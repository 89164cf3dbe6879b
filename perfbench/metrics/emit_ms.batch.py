"""Host time of a search call turning a tile's answers into result lists:
the program's span ``search.emit`` less its child ``search.emit.wait`` (the
device-to-host copies, which wait for the device), ms a call. Layer: API
and host driver (``search/searcher.py``)."""

from perfbench.spans import span_ms


def read(rec):
    return span_ms(rec, ("search.emit",), minus=("search.emit.wait",))
