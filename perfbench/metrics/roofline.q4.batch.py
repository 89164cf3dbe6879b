"""The q4 prefilter kernel's share of its roofline (%): the least time its
launches' work needs (``work.rerank_work`` with the q4 half cap) over
``maxsim_q4_gather_kernel``'s device time. Layer: stage 6 kernels."""

from perfbench.tracing import roofline_share


def read(rec):
    return roofline_share(rec, "q4")
