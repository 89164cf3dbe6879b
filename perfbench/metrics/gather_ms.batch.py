"""Host time inside the native row gather (``native.gather_windows_u8``) a
search call (ms). Layer: host row gather (``searcher.host_gather_rows``)."""


def read(rec):
    if not rec["gather_s"] or not rec["calls"]:
        return None
    return sum(rec["gather_s"]) / len(rec["calls"]) * 1e3
