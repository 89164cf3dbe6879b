"""Stages 1-2 of the cascade: query-centroid scores and the IVF probe.

The JAX package has no Pallas kernel here: it scores query tokens against
the centroids with an XLA dot and probes with ``approx_max_k``. The port's
table route, ``probe_table`` and then ``torch.topk``, writes the whole
[N, Kp] score table; ``probe_topk`` computes each row's k best cells without
it, through ``csrc/probe_kernel.cu`` (one wgmma kernel that keeps each row's
running top-k in registers, then a small merge of the centroid axis's
splits) for tensors on a GPU, and through ``probe_topk_plain``, the table
route, for tensors on the CPU. The kernel's bound is its operations:
N x k_real x D x 2 = 68.7 GFLOP at the benchmark's shape (N 8,192 query
tokens, 32,768 cells, D 128), 0.069 ms at the H100's 989 bf16 TFLOP/s.

The contract (the kernel's and the plain version's): from 32k cells on,
scores are bf16-rounded products of bf16-rounded inputs summed in float32,
then rounded to bf16; columns at or past ``k_real`` and rows whose float32
query token is all zeros score -inf; each row's k best come out descending,
exact ties in the order ``torch.topk`` gives them on a GPU (stage 3's rank
admission reads each cell's rank, so the order of ties moves the cascade's
answers). The kernel keeps the k best with ties to the lower cell, which is
the set ``torch.topk`` keeps, and ``_topk_order`` then orders them as
``torch.topk`` does. A slot with no cell (-inf) holds the cell Kp from the
kernel and some index from ``torch.topk``. The kernel's float32 sums run in
another order, so its scores may differ from the plain version's by one
bf16 ulp, and its cells only where two scores lie that close.
"""

from __future__ import annotations

import torch

from fast_plaid_tpu_torch.ops import codec

__all__ = ["BF16_FROM", "MAX_K", "probe_table", "probe_topk", "probe_topk_plain"]

NEG = float("-inf")
MAX_K = 32  # the kernel's longest top-k list (csrc/probe_kernel.cu, kMaxK)
BF16_FROM = 32768  # from this many cells on the table and its inputs are bf16


def probe_table(
    queries: torch.Tensor,  # [N, D] float32 query tokens (zero rows: padding)
    centroids: torch.Tensor,  # [Kp, D]; rows >= k_real are padding
    k_real: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """([N, Kp] query-centroid scores, the same with padding cells and
    all-zero query rows at -inf). From ``BF16_FROM`` cells on the table is
    bf16 and its inputs are bf16 (float32 accumulation); below it, float32."""
    kp = centroids.shape[0]
    if kp >= BF16_FROM:
        scores = codec.bf16_matmul(queries, centroids.t()).to(torch.bfloat16)
    else:
        scores = torch.matmul(queries, centroids.to(torch.float32).t())
    tok_ok = torch.sum(torch.abs(queries), dim=-1) > 0  # [N]
    cell_valid = torch.arange(kp, device=queries.device) < k_real
    return scores, torch.where(cell_valid[None, :] & tok_ok[:, None], scores, NEG)


def probe_topk_plain(
    queries: torch.Tensor, centroids: torch.Tensor, k_real: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``torch.topk`` over ``probe_table``'s masked
    table; (scores [N, k] descending, cells [N, k] int32)."""
    _, scores = probe_table(queries, centroids, k_real)
    vals, idx = torch.topk(scores, k, dim=-1)
    return vals, idx.to(torch.int32)


def _topk_order(
    vals: torch.Tensor, cells: torch.Tensor, kp: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's k best (descending, ties to the lower cell) in the order
    ``torch.topk`` gives them on a GPU: it gathers the cells above the k-th
    score, then those equal to it, each run in cell order, and sorts that
    list by score with the unstable small sort (``sortKeyValueInplace``)
    that ``torch.sort`` also runs on rows of at most 32, so exact ties come
    out as that sort leaves them."""
    tie = vals == vals[:, -1:]
    pos = torch.argsort(tie.to(torch.int64) * (kp + 1) + cells, dim=-1)
    vals, cells = torch.gather(vals, 1, pos), torch.gather(cells, 1, pos)
    vals, perm = torch.sort(vals, dim=-1, descending=True)
    return vals, torch.gather(cells, 1, perm)


def probe_topk(
    queries: torch.Tensor,  # [N, D] float32
    centroids: torch.Tensor,  # [Kp, D] bf16
    k_real: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query-token row's k best cells among the first ``k_real``:
    (scores [N, k] bf16 descending, cells [N, k] int32), ties in
    ``torch.topk``'s order. Launches the CUDA kernel for CUDA tensors
    (counted in ``probe_topk.launches``; it takes D a multiple of 16 up to
    256 and k up to ``MAX_K``) and the plain version for CPU tensors."""
    if queries.device.type == "cpu":
        return probe_topk_plain(queries, centroids, k_real, k)
    from fast_plaid_tpu_torch.ops._build import check, count_launch, load_library

    name = "probe_topk"
    if queries.device.type != "cuda":
        msg = f"{name}: unsupported device {queries.device}"
        raise ValueError(msg)
    if queries.ndim != 2 or queries.dtype != torch.float32:
        msg = f"{name}: queries must be an [N, D] float32 tensor"
        raise TypeError(msg)
    if centroids.ndim != 2 or centroids.dtype != torch.bfloat16:
        msg = f"{name}: centroids must be a [Kp, D] bf16 tensor"
        raise TypeError(msg)
    if centroids.device != queries.device:
        msg = f"{name}: centroids are on {centroids.device}, not {queries.device}"
        raise ValueError(msg)
    n, d = queries.shape
    kp = centroids.shape[0]
    if centroids.shape[1] != d:
        msg = f"{name}: centroids {tuple(centroids.shape)} must have D={d}"
        raise ValueError(msg)
    if not 1 <= k_real <= kp or not 1 <= k <= MAX_K or n < 1:
        msg = (
            f"{name}: needs 1 <= k_real <= Kp, 1 <= k <= {MAX_K} and N >= 1; "
            f"got k_real={k_real}, Kp={kp}, k={k}, N={n}"
        )
        raise ValueError(msg)
    lib = load_library()
    scratch_bytes = lib.fp_probe_scratch_bytes(n, d, k_real, k)
    if scratch_bytes < 0:
        msg = f"{name}: the kernel takes D a multiple of 16 up to 256; got D={d}"
        raise ValueError(msg)
    queries = queries.contiguous()
    centroids = centroids.contiguous()
    if queries.data_ptr() % 16:
        queries = queries.clone()
    if centroids.data_ptr() % 16:
        centroids = centroids.clone()
    scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=queries.device)
    scores = torch.empty((n, k), dtype=torch.bfloat16, device=queries.device)
    cells = torch.empty((n, k), dtype=torch.int32, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    status = lib.fp_probe_topk(
        queries.data_ptr(),
        n,
        d,
        centroids.data_ptr(),
        kp,
        k_real,
        k,
        scratch.data_ptr(),
        scores.data_ptr(),
        cells.data_ptr(),
        stream,
    )
    check(status, name)
    count_launch(probe_topk)
    return _topk_order(scores, cells, kp)


probe_topk.launches = 0
