"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they build the kernels with nvcc and need a CUDA device, so
they skip on a machine without one. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

from __future__ import annotations

import pytest
import torch

from fast_plaid_tpu_torch.ops.estimate_kernel import (
    segmented_estimate,
    segmented_estimate_plain,
)
from fast_plaid_tpu_torch.ops.rerank_kernel import (
    maxsim_gather_scores,
    maxsim_gather_scores_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "b,w,c,q,hi",
    [(4, 1000, 12, 16, 300), (3, 2049, 7, 8, 1), (2, 130, 40, 32, 50), (2, 300, 5, 100, 90)],
)
def test_estimate_kernel_matches_plain(cuda, b, w, c, q, hi):
    g = torch.Generator(device=cuda).manual_seed(w)
    pid = torch.sort(
        torch.randint(0, hi, (b, w), generator=g, device=cuda, dtype=torch.int32), dim=-1
    ).values
    own = torch.randint(0, c, (b, w), generator=g, device=cuda, dtype=torch.int32)
    tbl = torch.randn((b, c, q), generator=g, device=cuda)
    before = segmented_estimate.launches
    got = segmented_estimate(pid, own, tbl)
    assert segmented_estimate.launches == before + 1
    want = segmented_estimate_plain(pid, own, tbl)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_rerank_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    emb = torch.randn((300, 64, 128), generator=g, device=cuda).to(torch.bfloat16)
    pids = torch.randint(0, 300, (5, 77), generator=g, device=cuda, dtype=torch.int32)
    lens = torch.randint(0, 65, (5, 77), generator=g, device=cuda, dtype=torch.int32)
    pids[0, :3] = torch.tensor([-1, 300, 299], dtype=torch.int32, device=cuda)
    lens[1, :2] = 0
    queries = torch.randn((5, 24, 128), generator=g, device=cuda)
    before = maxsim_gather_scores.launches
    got = maxsim_gather_scores(emb, pids, lens, queries)
    assert maxsim_gather_scores.launches == before + 1
    want = maxsim_gather_scores_plain(emb, pids, lens, queries)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-3, atol=1e-3)
    assert torch.isneginf(got[0, :2]).all() and torch.isneginf(got[1, :2]).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    emb = torch.zeros((8, 24, 128), dtype=torch.bfloat16, device=cuda)  # doc_cap % 16
    ids = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        maxsim_gather_scores(emb, ids, ids, torch.zeros((1, 8, 128), device=cuda))
    with pytest.raises(TypeError):
        segmented_estimate(ids.long(), ids.long(), torch.zeros((1, 2, 8), device=cuda))
