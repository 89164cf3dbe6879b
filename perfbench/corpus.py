"""Seeded ColBERT-proxy corpus and queries, generated on the device.

A vectorised PyTorch rewrite of the ColBERT-proxy statistics (anisotropic
cone, Zipf topics, Zipf-weighted hub tokens that make the giant IVF cells
real corpora have, lexical query tokens copied from a target document,
[MASK] query slots). Every draw comes from one ``torch.Generator`` on the
device, in a fixed order, so one seed gives the same arrays on one device.
It is not meant to match any other generator bit for bit.

Lengths are lognormal (sigma ``len_sigma``) with mean ``mean_len`` before
the clip to [``min_len``, ``doc_maxlen``]; document 0 always has
``doc_maxlen`` tokens, so the index's ``doc_cap`` never moves.

The documents come from the configuration's ``corpus_seed``: a deployment
serves one corpus, and every run then has the same index and the same work.
The queries (and so the traffic) come from the run's seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["Corpus", "generate"]

# Tokens drawn per block: bounds the float32 temporaries to ~0.5 GB.
BLOCK = 1 << 20


@dataclass
class Corpus:
    tokens: torch.Tensor  # [T, D] float32, documents back to back
    lengths: torch.Tensor  # [N] int64
    offsets: torch.Tensor  # [N] int64 start of each document in ``tokens``
    is_hub: torch.Tensor  # [T] bool, hub (stopword-like) tokens
    queries: torch.Tensor  # [Nq, Q, D] float32
    targets: torch.Tensor  # [Nq] int64, the document each query was drawn from
    lexical_src: torch.Tensor  # [Nq, n_lex] int64, token rows copied into each query


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def generate(cfg: dict, n_queries: int, seed: int, device: torch.device) -> Corpus:
    """The corpus of configuration ``cfg`` and ``n_queries`` queries of it,
    drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(cfg["corpus_seed"]) % (1 << 63))
    d = int(cfg["dim"])
    n = int(cfg["n_docs"])
    q_len = int(cfg["query_maxlen"])
    n_topics = int(cfg.get("n_topics") or max(64, n // 32))
    n_hubs = int(cfg["n_hubs"])
    aniso = float(cfg["anisotropy"])
    topic_w = float(cfg["topic_weight"])

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    axis = _unit(randn(1, d))

    def cone(x):
        return _unit(aniso * axis + (1.0 - aniso) * _unit(x))

    topics = cone(randn(n_topics, d))
    hubs = cone(randn(n_hubs, d))
    mask_vec = cone(randn(1, d))[0]
    ranks = torch.arange(1, n_topics + 1, device=device, dtype=torch.float64)
    pop = (1.0 / ranks ** float(cfg["topic_zipf"])).float()
    hub_pop = (
        1.0 / torch.arange(1, n_hubs + 1, device=device, dtype=torch.float64)
        ** float(cfg["hub_zipf"])
    ).float()

    # Lognormal lengths with the stated mean: mu = ln(mean) - sigma^2 / 2.
    sigma = float(cfg["len_sigma"])
    mu = math.log(float(cfg["mean_len"])) - sigma * sigma / 2
    raw = torch.exp(mu + sigma * randn(n).double())
    lengths = torch.clamp(raw.long(), int(cfg["min_len"]), int(cfg["doc_maxlen"]))
    lengths[0] = int(cfg["doc_maxlen"])
    offsets = torch.cumsum(lengths, 0) - lengths
    t_total = int(lengths.sum())

    # Each document holds 1-3 Zipf-drawn topics.
    n_doc_topics = torch.randint(1, 4, (n,), generator=g, device=device)
    doc_topics = torch.multinomial(pop, 3 * n, replacement=True, generator=g).view(n, 3)

    tokens = torch.empty((t_total, d), dtype=torch.float32, device=device)
    is_hub = torch.empty((t_total,), dtype=torch.bool, device=device)
    doc_of = torch.repeat_interleave(torch.arange(n, device=device), lengths)
    hub_jitter = 0.15 / math.sqrt(d)
    for s in range(0, t_total, BLOCK):
        e = min(s + BLOCK, t_total)
        docs = doc_of[s:e]
        pick = (rand(e - s) * n_doc_topics[docs]).long()
        tid = doc_topics[docs, pick]
        tok = _unit(topic_w * topics[tid] + (1 - topic_w) * randn(e - s, d))
        hub = rand(e - s) < float(cfg["hub_frac"])
        hid = torch.multinomial(hub_pop, e - s, replacement=True, generator=g)
        hub_tok = _unit(hubs[hid] + hub_jitter * randn(e - s, d))
        tokens[s:e] = torch.where(hub[:, None], hub_tok, tok)
        is_hub[s:e] = hub

    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    # Queries: topical tokens of a target document, then ``lexical_frac``
    # of the slots copied (with jitter) from its tokens, then [MASK] slots.
    targets = torch.randint(0, n, (n_queries,), generator=g, device=device)
    pick = (rand(n_queries, q_len) * n_doc_topics[targets][:, None]).long()
    tid = torch.gather(doc_topics[targets], 1, pick)
    queries = _unit(topic_w * topics[tid] + (1 - topic_w) * 1.3 * randn(n_queries, q_len, d))
    n_lex = int(float(cfg["lexical_frac"]) * q_len)
    within = (rand(n_queries, n_lex) * lengths[targets][:, None]).long()
    lexical_src = offsets[targets][:, None] + within
    lex_jitter = 0.2 / math.sqrt(d)
    queries[:, :n_lex] = _unit(tokens[lexical_src] + lex_jitter * randn(n_queries, n_lex, d))
    n_mask = int(float(cfg["mask_frac"]) * q_len)
    if n_mask:
        mask_jitter = 0.25 / math.sqrt(d)
        queries[:, q_len - n_mask :] = _unit(
            mask_vec + mask_jitter * randn(n_queries, n_mask, d)
        )
    return Corpus(tokens, lengths, offsets, is_hub, queries, targets, lexical_src)
