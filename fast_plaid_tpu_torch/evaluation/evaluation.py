"""Retrieval evaluation: BEIR loading and ranking metrics.

A copy of ``fast_plaid_tpu/evaluation/evaluation.py`` (which has no JAX in
it, but its package imports JAX): ndcg@k / hits@k / recall@k / map@k /
precision@k / mrr@k in plain Python, the same values on the same inputs.
``load_beir`` needs the optional ``beir`` package and network access, and
raises ImportError without the package.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict

__all__ = ["add_duplicates", "load_beir", "evaluate"]


def add_duplicates(queries: list[str], scores: list[list[dict]]) -> list:
    """Replicate scores for duplicated queries (evaluation.py:6-31)."""
    query_to_result: dict[str, list[dict]] = {}
    for i, query in enumerate(queries):
        if query not in query_to_result and i < len(scores):
            query_to_result[query] = scores[i]
    return [query_to_result[q] for q in queries if q in query_to_result]


def load_beir(dataset_name: str, split: str = "test") -> tuple[list, list, dict, dict]:
    """Download and load a BEIR dataset (requires the optional `beir` package).

    Returns (documents, queries, qrels, documents_ids) with the same
    structure as the reference (evaluation.py:34-89).
    """
    try:
        from beir import util
        from beir.datasets.data_loader import GenericDataLoader
    except ImportError as exc:  # pragma: no cover - optional dependency
        msg = (
            "load_beir requires the optional 'beir' package "
            "(pip install beir) and network access."
        )
        raise ImportError(msg) from exc

    data_path = util.download_and_unzip(
        url=(
            "https://public.ukp.informatik.tu-darmstadt.de/thakur/BEIR/"
            f"datasets/{dataset_name}.zip"
        ),
        out_dir="./evaluation_datasets/",
    )
    documents, queries, qrels = GenericDataLoader(data_folder=data_path).load(
        split=split
    )
    documents = [
        {
            "id": document_id,
            "text": (
                f"{document['title']} {document['text']}".strip()
                if "title" in document
                else document["text"].strip()
            ),
        }
        for document_id, document in documents.items()
    ]
    qrels = {queries[qid]: docs for qid, docs in qrels.items()}
    documents_ids = {i: d["id"] for i, d in enumerate(documents)}
    return documents, queries, qrels, documents_ids


# ---------------------------------------------------------------------------
# metric math (owned; no ranx)
# ---------------------------------------------------------------------------


def _ranked_ids(matches: list[dict]) -> list[str]:
    return [
        m["id"]
        for m in sorted(matches, key=lambda m: -float(m["score"]))
    ]


def _rel(qrel: dict, doc_id: str) -> float:
    val = qrel.get(doc_id, 0)
    return float(val) if not isinstance(val, bool) else float(int(val))


def _ndcg_at_k(ranked: list[str], qrel: dict, k: int) -> float:
    gains = [_rel(qrel, d) for d in ranked[:k]]
    dcg = sum(g / math.log2(i + 2) for i, g in enumerate(gains))
    ideal = sorted((float(v) for v in qrel.values()), reverse=True)[:k]
    idcg = sum(g / math.log2(i + 2) for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def _hits_at_k(ranked: list[str], qrel: dict, k: int) -> float:
    return 1.0 if any(_rel(qrel, d) > 0 for d in ranked[:k]) else 0.0


def _recall_at_k(ranked: list[str], qrel: dict, k: int) -> float:
    relevant = {d for d, v in qrel.items() if _rel(qrel, d) > 0}
    if not relevant:
        return 0.0
    return len(relevant & set(ranked[:k])) / len(relevant)


def _precision_at_k(ranked: list[str], qrel: dict, k: int) -> float:
    if k == 0:
        return 0.0
    return sum(1 for d in ranked[:k] if _rel(qrel, d) > 0) / k


def _map_at_k(ranked: list[str], qrel: dict, k: int) -> float:
    relevant = {d for d, v in qrel.items() if _rel(qrel, d) > 0}
    if not relevant:
        return 0.0
    hits, total = 0, 0.0
    for i, d in enumerate(ranked[:k]):
        if d in relevant:
            hits += 1
            total += hits / (i + 1)
    return total / min(len(relevant), k)


def _mrr_at_k(ranked: list[str], qrel: dict, k: int) -> float:
    for i, d in enumerate(ranked[:k]):
        if _rel(qrel, d) > 0:
            return 1.0 / (i + 1)
    return 0.0


_METRIC_FNS = {
    "ndcg": _ndcg_at_k,
    "hits": _hits_at_k,
    "recall": _recall_at_k,
    "precision": _precision_at_k,
    "map": _map_at_k,
    "mrr": _mrr_at_k,
}


def _parse_metric(name: str) -> tuple[str, int]:
    m = re.fullmatch(r"([a-z_]+)(?:@(\d+))?", name.strip().lower())
    if not m or m.group(1) not in _METRIC_FNS:
        msg = f"Unknown metric: {name!r}"
        raise ValueError(msg)
    return m.group(1), int(m.group(2) or 10)


def evaluate(
    scores: list[list[dict]],
    qrels: dict,
    queries: list[str],
    metrics: list | None = None,
) -> dict[str, float]:
    """Score ranked results against qrels; averaged over queries with qrels.

    ``scores`` is per query a list of {"id": str, "score": float}; ``qrels``
    maps query text -> {doc_id: relevance}. Metric names: "ndcg@10",
    "hits@1", "recall@100", "map@10", "precision@5", "mrr@10".
    """
    if len(queries) > len(scores):
        scores = add_duplicates(queries=queries, scores=scores)
    if not metrics:
        metrics = ["ndcg@10"] + [f"hits@{k}" for k in [1, 2, 3, 4, 5, 10]]

    per_metric: dict[str, list[float]] = defaultdict(list)
    for query, matches in zip(queries, scores):
        qrel = qrels.get(query)
        if not qrel:
            continue
        ranked = _ranked_ids(matches)
        for name in metrics:
            fn_name, k = _parse_metric(name)
            per_metric[name].append(_METRIC_FNS[fn_name](ranked, qrel, k))

    return {
        name: (sum(vals) / len(vals) if vals else 0.0)
        for name, vals in per_metric.items()
    }
