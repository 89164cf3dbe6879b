"""The bf16-cache rerank's share of its roofline (%): the least time its
launches' work needs (``work.rerank_work``: each distinct row read once)
over the device time of whichever of ``maxsim_dedup_kernel`` and
``maxsim_gather_kernel`` ran. Layer: stage 6 kernels."""

from perfbench.tracing import roofline_share


def read(rec):
    return roofline_share(rec, "rerank")
