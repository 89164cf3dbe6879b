"""Evaluation tooling: ranking metrics, BEIR loading, synthetic corpora and
exhaustive MaxSim truth."""

from fast_plaid_tpu_torch.evaluation.evaluation import (
    add_duplicates,
    evaluate,
    load_beir,
)

__all__ = ["evaluate", "load_beir", "add_duplicates"]
