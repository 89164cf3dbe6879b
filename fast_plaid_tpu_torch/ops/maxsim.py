"""Masked MaxSim (ColBERT late-interaction) reduction.

Port of ``fast_plaid_tpu/ops/maxsim.py``: for token scores
``s[..., t_doc, t_query]`` and doc-token mask ``m[..., t_doc]``,
``score = sum_q max_{t valid} s[..., t, q]``. A row with no valid token
scores ``Q * NEG_INF``.
"""

from __future__ import annotations

import torch

__all__ = ["maxsim_reduce", "NEG_INF"]

NEG_INF = -9999.0  # the reference's sentinel


def maxsim_reduce(token_scores: torch.Tensor, doc_mask: torch.Tensor) -> torch.Tensor:
    """Masked MaxSim: [..., Ld, Q] scores + [..., Ld] mask -> [...] score."""
    masked = torch.where(
        doc_mask[..., None], token_scores, torch.full_like(token_scores, NEG_INF)
    )
    return torch.sum(torch.amax(masked, dim=-2), dim=-1)
