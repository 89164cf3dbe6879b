#!/usr/bin/env python3
"""Retrieval-quality parity of the PyTorch port: PLAID cascade vs exact search.

The port's counterpart of ``docs/benchmark/quality_parity.py``, with the
same ``run()`` arguments and the same JSON keys, over
``fast_plaid_tpu_torch``'s FastPlaid. It makes a seeded synthetic corpus
(``fast_plaid_tpu_torch.evaluation.synthetic``: bit-identical to the JAX
package's for the same seed), takes exhaustive MaxSim as the truth and
reports nDCG@10 / recall@10 / recall@100 / mrr@10 of

  * ``exact_decompressed``: exhaustive MaxSim over the compressed-then-
    decompressed embeddings (``get_embeddings``; the quantization loss);
  * ``cascade_default``: the PLAID cascade at default parameters, top_k 100
    (candidate generation and pruning on top);
  * ``pool_divisor_sweep``: the cascade at each ``--sweep-divisors`` pool
    divisor (R = n_full_scores / divisor) on the same index and truth.

The truth and the exact search run on the CUDA card by default
(``exact_maxsim_topk``'s blocked bf16-input path); ``--device cpu`` runs the
index on the CPU and the truth on the numpy host path.

    python3 tools/quality_parity_torch.py [--docs 5000] [--queries 200]
        [--generator topic|colbert_proxy|colbert_proxy_graded] [--doc-len 300]
        [--sweep-divisors 4,8] [--pool-divisor N] [--low-memory 0|1]
        [--device cpu] [--out build/quality_parity_torch.json]

``--low-memory 1`` (the default, as ``FastPlaid``'s) searches with the
default constructor: residuals in host RAM, the q4 prefilter on the card;
``0`` opens the index resident. Writes the JSON to ``--out`` (by default
under ``build/``, which git ignores).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ["ndcg@10", "recall@10", "recall@100", "mrr@10"]


def score(rows, qrels: dict, qids: list) -> dict:
    """The four metrics of ranked (doc_id, score) rows against qrels."""
    from fast_plaid_tpu_torch.evaluation import evaluate

    fmt = [[{"id": str(p), "score": s} for p, s in row] for row in rows]
    return evaluate(fmt, qrels, qids, metrics=METRICS)


def make_corpus(n_docs, n_queries, dim, seed, generator="topic", doc_len=None):
    """(docs, queries, targets) of the named generator, from ``seed``."""
    from fast_plaid_tpu_torch.evaluation.synthetic import (
        colbert_proxy_corpus,
        topic_corpus,
    )

    gen = topic_corpus if generator == "topic" else colbert_proxy_corpus
    gen_kw = {}
    if doc_len is not None:
        # BEIR regime (the reference's benchmark truncates documents at 300
        # tokens): mean at the cap's neighborhood, capped at doc_len.
        gen_kw = {"mean_len": int(doc_len * 0.8), "max_len": int(doc_len)}
    if generator == "colbert_proxy_graded":
        # Graded relevance (BEIR's protocol: qrels, not exhaustive MaxSim):
        # 5 relevant docs per query with descending term-match counts.
        gen_kw["graded_targets"] = 5
    return gen(np.random.default_rng(seed), n_docs, n_queries, dim=dim, **gen_kw)


def run(
    n_docs: int,
    n_queries: int,
    dim: int,
    seed: int,
    device: str | None,
    generator: str = "topic",
    pool_divisor: int | None = None,
    doc_len: int | None = None,
    sweep_divisors: list[int] | None = None,
    low_memory: bool = True,
    index_dir: str | None = None,
    state: dict | None = None,
) -> dict:
    """Build, search and score one corpus; returns the JSON record.

    ``device``: None for every CUDA device (raises without one), or a
    device string ("cpu", "cuda:0"). ``index_dir``: build the index there
    and keep it (by default a temporary directory, removed at the end).
    ``state``: a dict that receives the corpus, the truth and the qrels, for
    a caller that checks more on the same index.
    """
    from fast_plaid_tpu_torch.evaluation.synthetic import (
        exact_maxsim_topk,
        graded_qrels,
        truth_qrels,
    )
    from fast_plaid_tpu_torch.search import FastPlaid

    graded = generator == "colbert_proxy_graded"
    t0 = time.perf_counter()
    docs, queries, targets = make_corpus(n_docs, n_queries, dim, seed, generator, doc_len)
    n_tokens = sum(len(d) for d in docs)
    corpus_s = time.perf_counter() - t0
    print(f"# corpus: {n_docs} docs / {n_tokens} tokens / {n_queries} queries "
          f"({corpus_s:.1f}s)", flush=True)

    t0 = time.perf_counter()
    truth = exact_maxsim_topk(docs, queries, top_k=100, device=device)
    if graded:
        qids, qrels = graded_qrels(targets)
    else:
        qids, qrels = truth_qrels(truth, depth=10)
    truth_s = time.perf_counter() - t0
    print(f"# exact truth on raw embeddings ({truth_s:.1f}s)", flush=True)
    if state is not None:
        state.update(docs=docs, queries=queries, targets=targets, truth=truth,
                     qids=qids, qrels=qrels, n_tokens=n_tokens,
                     seconds={"corpus": corpus_s, "truth": truth_s})

    with tempfile.TemporaryDirectory() as tmp:
        path = index_dir or os.path.join(tmp, "idx")
        engine = FastPlaid(index=path, device=device, low_memory=low_memory)
        t0 = time.perf_counter()
        engine.create(documents_embeddings=docs, show_progress=False)
        build_s = time.perf_counter() - t0

        # Exact search over the same compressed representation: exhaustive
        # MaxSim on the decompressed embeddings (no candidate generation).
        t0 = time.perf_counter()
        recon = engine.get_embeddings(list(range(n_docs)))
        exact_dec = exact_maxsim_topk(recon, queries, top_k=100, device=device)
        exact_s = time.perf_counter() - t0
        del recon

        t0 = time.perf_counter()
        cascade = engine.search(
            queries, top_k=100, show_progress=False, pool_divisor=pool_divisor
        )
        cascade_s = time.perf_counter() - t0

        # The rerank-pool sweep on the same index and truth: quality against
        # pool size R = n_full_scores / divisor.
        sweep = {}
        for div in sweep_divisors or []:
            t0 = time.perf_counter()
            rows = engine.search(queries, top_k=100, show_progress=False, pool_divisor=div)
            sweep[div] = (rows, time.perf_counter() - t0)
        engine.close()
    print(f"# index build {build_s:.2f}s, get_embeddings + exact search {exact_s:.2f}s, "
          f"cascade {cascade_s:.2f}s", flush=True)

    out = {
        "corpus": {
            "n_docs": n_docs,
            "n_queries": n_queries,
            "dim": dim,
            "seed": seed,
            "generator": f"evaluation.synthetic.{generator}",
            "doc_len": doc_len,
            "pool_divisor": pool_divisor,
        },
        "truth": (
            "generator graded qrels (5 docs/query, relevance 5..1)"
            if graded
            else "exhaustive MaxSim on raw embeddings, qrels = top-10"
        ),
        "exact_raw": score(truth, qrels, qids) if graded else None,
        "exact_decompressed": score(exact_dec, qrels, qids),
        "cascade_default": score(cascade, qrels, qids),
        "timing_s": {
            "index_build": round(build_s, 2),
            "exact_decompressed_search": round(exact_s, 2),
            "cascade_search": round(cascade_s, 2),
        },
    }
    out["parity"] = {
        "ndcg10_gap_cascade_vs_exact_decompressed": round(
            out["exact_decompressed"]["ndcg@10"] - out["cascade_default"]["ndcg@10"], 4
        ),
        "target": "<= 0.01",
    }
    if sweep:
        out["pool_divisor_sweep"] = {}
        for div, (rows, dt) in sweep.items():
            m = score(rows, qrels, qids)
            out["pool_divisor_sweep"][str(div)] = {
                **m,
                "cascade_search_s": round(dt, 2),
                "ndcg10_gap_vs_exact_decompressed": round(
                    out["exact_decompressed"]["ndcg@10"] - m["ndcg@10"], 4
                ),
            }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=5000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help='"cpu" or "cuda[:N]"; default every CUDA device')
    ap.add_argument("--pool-divisor", type=int, default=None)
    ap.add_argument("--doc-len", type=int, default=None)
    ap.add_argument("--sweep-divisors", default=None,
                    help="comma-separated pool divisors to evaluate as well on "
                    "the same index and truth (e.g. 4,8)")
    ap.add_argument("--low-memory", type=int, choices=[0, 1], default=1,
                    help="1: the default constructor (low_memory); 0: resident")
    ap.add_argument("--out", default=None, help="result file (default under build/)")
    ap.add_argument("--generator", default="topic",
                    choices=["topic", "colbert_proxy", "colbert_proxy_graded"],
                    help="corpus statistics: plain topic model or the ColBERT proxy "
                    "(anisotropy + hub tokens + lexical query matches + MASK padding)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    out = run(
        args.docs, args.queries, args.dim, args.seed, args.device,
        generator=args.generator, pool_divisor=args.pool_divisor,
        doc_len=args.doc_len,
        sweep_divisors=(
            [int(x) for x in args.sweep_divisors.split(",")]
            if args.sweep_divisors else None
        ),
        low_memory=bool(args.low_memory),
    )
    path = args.out or os.path.join(ROOT, "build", f"quality_parity_torch_{args.generator}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    print(f"# written to {path}")


if __name__ == "__main__":
    main()
