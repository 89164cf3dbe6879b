"""The device ColBERT-proxy generator, at a tiny size on the CPU."""

import pytest
import torch
from conftest import SEED, tiny_config

from perfbench import corpus


@pytest.fixture(scope="module")
def cfg():
    return dict(tiny_config("q4"), n_docs=3000, n_hubs=32)


@pytest.fixture(scope="module")
def data(cfg):
    return corpus.generate(cfg, 64, SEED, torch.device("cpu"))


def test_lengths_clipped_and_first_document_longest(cfg, data):
    assert int(data.lengths[0]) == cfg["doc_maxlen"]
    assert int(data.lengths.min()) >= cfg["min_len"]
    assert int(data.lengths.max()) == cfg["doc_maxlen"]
    assert data.tokens.shape == (int(data.lengths.sum()), cfg["dim"])
    assert torch.equal(data.offsets, torch.cumsum(data.lengths, 0) - data.lengths)


def test_tokens_unit_norm(data):
    norms = torch.linalg.vector_norm(data.tokens, dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    qn = torch.linalg.vector_norm(data.queries, dim=-1)
    assert torch.allclose(qn, torch.ones_like(qn), atol=1e-5)


def test_hub_share_and_hubs_recur(cfg, data):
    share = float(data.is_hub.float().mean())
    assert abs(share - cfg["hub_frac"]) < 0.01
    hubs = data.tokens[data.is_hub][:2000]
    # Hub tokens are near-copies of 32 vectors: each has a near-twin.
    sim = hubs @ hubs.T
    sim.fill_diagonal_(-1)
    assert float(sim.max(dim=1).values.median()) > 0.95


def test_mask_slots(cfg, data):
    n_mask = int(cfg["mask_frac"] * cfg["query_maxlen"])
    assert n_mask == 11
    tail = data.queries[:, -n_mask:].reshape(-1, cfg["dim"])
    sim = tail @ tail.T
    assert float(sim.min()) > 0.8  # all near one shared [MASK] vector
    head = data.queries[:, : cfg["query_maxlen"] - n_mask].reshape(-1, cfg["dim"])
    assert float((head @ tail.mean(0)).mean()) < float((tail @ tail.mean(0)).mean()) - 0.1


def test_lexical_tokens_taken_from_target(cfg, data):
    n_lex = int(cfg["lexical_frac"] * cfg["query_maxlen"])
    src = data.lexical_src
    assert src.shape == (64, n_lex)
    start = data.offsets[data.targets][:, None]
    end = start + data.lengths[data.targets][:, None]
    assert bool(((src >= start) & (src < end)).all())
    cos = torch.sum(data.queries[:, :n_lex] * data.tokens[src], dim=-1)
    assert float(cos.min()) > 0.95


def test_same_seed_same_arrays_and_one_corpus(cfg, data):
    again = corpus.generate(cfg, 64, SEED, torch.device("cpu"))
    for name in ("tokens", "lengths", "queries", "targets", "lexical_src", "is_hub"):
        assert torch.equal(getattr(data, name), getattr(again, name)), name
    other = corpus.generate(cfg, 64, SEED + 1, torch.device("cpu"))
    assert torch.equal(data.tokens, other.tokens)  # one corpus a deployment
    assert not torch.equal(data.queries, other.queries)  # the seed draws the traffic
    moved = corpus.generate(dict(cfg, corpus_seed=cfg["corpus_seed"] + 1), 64, SEED, torch.device("cpu"))
    assert not torch.equal(data.lengths, moved.lengths)
