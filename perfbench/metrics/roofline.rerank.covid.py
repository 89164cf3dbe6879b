"""The TREC-COVID cell's stage-6 kernel's share of its roofline (%):
``work.rerank_work`` at D 96 (each distinct row read once) over the device
time of whichever of ``maxsim_dedup_kernel`` and ``maxsim_gather_kernel``
ran, read as ``roofline.rerank.batch`` reads it. Layer: stage 6 kernels."""

from perfbench.harness import metric_reader

read = metric_reader("roofline.rerank.batch")
