"""The stage-4 estimate kernel's share of its roofline (%): the least time
its launches' work needs (``work.estimate_work``) over ``estimate_kernel``'s
device time. Layer: stage 4 kernel (``ops/estimate_kernel.py``)."""

from perfbench.tracing import roofline_share


def read(rec):
    return roofline_share(rec, "estimate")
