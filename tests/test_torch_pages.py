"""ColPali-shaped pages (arXiv:2407.01449: 1,030 vectors of 128 a page) at
a CPU size: 48 pages, resident, through ``FastPlaid.create`` and ``search``,
held against ``perfbench.reference`` by ``perfbench.judge``.

On the CPU stage 6 takes the kernel wrappers' plain versions once
``searcher.kernel_flags`` routes the bf16 cache through them, as a card
does: pools drawn from 48 pages open the dedup gate, so the plain dedup path
stands in for the dedup kernel.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_plaid_tpu_torch.ops import kmeans as kmeans_ops
from fast_plaid_tpu_torch.ops import rerank_dedup
from fast_plaid_tpu_torch.search import FastPlaid, searcher
from fast_plaid_tpu_torch.utils import tracing
from perfbench import corpus, judge

ROOT = Path(__file__).resolve().parents[1]
N_PAGES, N_QUERIES, N_FULL = 48, 16, 64  # N_FULL < 2 * N_PAGES: the cascade, not exhaustive
SEED = 4_000_000_321


def _pages_config() -> dict:
    """The ``pages`` deployment (resident, bf16 cache, pages of exactly 1,030
    vectors, its limits) at ``N_PAGES`` pages."""
    cfg = json.loads((ROOT / "perfbench" / "configs" / "pages.json").read_text())
    cfg.update(n_docs=N_PAGES)
    return cfg


def _mix() -> dict:
    mix = json.loads((ROOT / "perfbench" / "mixes" / "batch.json").read_text())
    mix.update(queries_per_call=N_QUERIES, query_pool=N_QUERIES)
    mix["search"]["n_full_scores"] = N_FULL
    return mix


def _subsample_size(t: int, k: int, ppc: int = 256, chunk: int = 16384) -> int:
    """The points ``train_kmeans`` keeps of ``t``: at most k * ppc, trimmed
    to whole chunks."""
    chunk = min(chunk, max(1024, (1 << 30) // (4 * k)))
    t = min(t, k * ppc)
    return (t // chunk) * chunk if t > chunk else t


@pytest.fixture(scope="module")
def pages_run(tmp_path_factory):
    """One create and one search call: (the judge's numbers, the recorder's
    drain of create, of search, plain dedup calls, configuration, K)."""
    cfg, mix = _pages_config(), _mix()
    data = corpus.generate(cfg, N_QUERIES, SEED, torch.device("cpu"))
    lengths = data.lengths.numpy()
    flat = data.tokens.numpy()
    queries = data.queries.numpy()
    docs = np.split(flat, np.cumsum(lengths)[:-1])
    path = str(tmp_path_factory.mktemp("pages") / "index")

    mp = pytest.MonkeyPatch()
    plain_calls = []
    plain = rerank_dedup.maxsim_gather_scores_dedup_plain
    mp.setattr(searcher, "kernel_flags", lambda dev: (False, dev.emb_cache is not None))
    mp.setattr(rerank_dedup, "maxsim_gather_scores_dedup_plain",
               lambda *a, **k: plain_calls.append(1) or plain(*a, **k))
    tracing.disable()
    tracing.drain()
    try:
        fp = FastPlaid(path, device="cpu", emb_cache_budget_bytes=100_000_000, **cfg["instance"])
        tracing.enable()
        fp.create(documents_embeddings=docs, **cfg["create"])
        built = tracing.drain()
        s = mix["search"]
        answers = fp.search(queries, top_k=s["top_k"], n_ivf_probe=s["n_ivf_probe"],
                            n_full_scores=s["n_full_scores"], approx_mode=s["approx_mode"],
                            show_progress=False)
        searched = tracing.drain()
        tracing.disable()
        fp.close()
    finally:
        tracing.disable()
        tracing.drain()
        mp.undo()
    side = judge.read_index(path, torch.device("cpu"))
    numbers = judge.judge(data.tokens, lengths, side, [(queries, answers)], cfg=cfg, mix=mix,
                          mem_budget=256 * 1024 * 1024, wire=np.float32)
    return numbers, built, searched, len(plain_calls), cfg, int(side.centroids.shape[0])


def test_pages_index_matches_the_reference(pages_run):
    """Codes beyond ``judge.CODE_TIE``, packed residual bytes, lengths and
    IVF pairs all agree, from centroids within the configuration's limit."""
    numbers, *_, cfg, _ = pages_run
    assert numbers["kmeans_gap"] <= cfg["limits"]["kmeans_gap"]
    assert numbers["codec_gap"] <= cfg["limits"]["codec_gap"]
    assert numbers["index_mismatch"] == 0


def test_pages_answers_match_the_reference(pages_run):
    """Every returned score within 1e-3 of the reference's exact MaxSim; no
    reference top-10 page that beats an answer's worst by more than
    ``judge.MISS_TIE`` left out."""
    numbers = pages_run[0]
    assert numbers["_judged"] == N_QUERIES
    assert numbers["bad_lists"] == 0
    assert numbers["score_err"] <= 1e-3
    assert numbers["miss_share"] == 0.0


def test_pages_take_the_dedup_route(pages_run):
    """Stage 6 went through the dedup wrapper's plain path, with live
    entries and its grouping span."""
    _, _, searched, plain_calls, _, _ = pages_run
    assert plain_calls >= 1
    assert searched["counters"]["rerank.entries"] > 0
    assert "rerank.group" in {s["name"] for s in searched["spans"]}


def test_pages_kmeans_points(pages_run):
    """``kmeans.points`` is the sample ``train_kmeans`` trains on: every
    sampled page's vectors (all 48 pages), capped at K * 256 and trimmed
    to whole chunks."""
    _, built, _, _, _, k = pages_run
    assert k == kmeans_ops.num_partitions_heuristic(N_PAGES * 1030)
    assert built["counters"]["kmeans.points"] == _subsample_size(N_PAGES * 1030, k)
