"""Share of the TREC-COVID cell's traced calls' span in which no device
operation ran (%), read as ``idle.batch`` reads it. Layer: device."""

from perfbench.harness import metric_reader

read = metric_reader("idle.batch")
