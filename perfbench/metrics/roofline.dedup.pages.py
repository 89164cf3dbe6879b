"""The dedup kernel's share of its roofline (%): the least time its
launches' work needs (``work.rerank_work``: each distinct row read once)
over ``maxsim_dedup_kernel``'s device time, the only stage-6 kernel of
this cell. Layer: stage 6 kernels."""

from perfbench.tracing import roofline_share


def read(rec):
    return roofline_share(rec, "rerank")
