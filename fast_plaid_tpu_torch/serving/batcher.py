"""Request coalescing for the batch-first search engine.

A copy of ``fast_plaid_tpu/serving/batcher.py`` (framework-free). The
cascade amortizes its launches over query tiles of up to 256 queries, so a
server must merge concurrent single-query requests into shared tiles.
``MicroBatcher`` queues (queries, params) pairs and a dispatcher thread
drains the queue into one ``engine.search`` call per distinct parameter
set, up to ``max_batch`` queries per dispatch, waiting at most
``max_wait_ms`` for stragglers once a request is pending.

Two priority lanes: lane 0 ("interactive") is always drained before
lane 1 ("batch"), so bulk re-scoring jobs never add head-of-line latency
to user-facing queries; within a lane, arrival order is preserved.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

__all__ = ["MicroBatcher", "BatchStats", "LANES"]

LANES = {"interactive": 0, "batch": 1}

# Upper edges (seconds) of the request-latency histogram, Prometheus-style
# cumulative buckets (an +Inf bucket is implicit).
LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


@dataclass
class BatchStats:
    requests: int = 0
    queries: int = 0
    dispatches: int = 0
    merged_batches: int = 0  # dispatches serving >1 request
    errors: int = 0
    latency_sum_s: float = 0.0  # submit -> result, summed over requests
    latency_buckets: list = field(
        default_factory=lambda: [0] * (len(LATENCY_BUCKETS) + 1)
    )
    lane_requests: list = field(default_factory=lambda: [0, 0])
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def observe(self, batch_len: int, total: int, lane: int, lat_s: list):
        with self._lock:
            self.requests += batch_len
            self.queries += total
            self.dispatches += 1
            self.merged_batches += 1 if batch_len > 1 else 0
            self.lane_requests[lane] += batch_len
            for s in lat_s:
                self.latency_sum_s += s
                for i, edge in enumerate(LATENCY_BUCKETS):
                    if s <= edge:
                        self.latency_buckets[i] += 1
                        break
                else:
                    self.latency_buckets[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests,
                "queries": self.queries,
                "dispatches": self.dispatches,
                "merged_batches": self.merged_batches,
                "errors": self.errors,
                "avg_batch": round(self.queries / max(self.dispatches, 1), 2),
                "avg_latency_ms": round(
                    1e3 * self.latency_sum_s / max(self.requests, 1), 2
                ),
                "lane_requests": {
                    name: self.lane_requests[i] for name, i in LANES.items()
                },
            }

    def prometheus(self) -> str:
        """Render the counters in Prometheus text exposition format."""
        with self._lock:
            lines = [
                "# TYPE fastplaid_requests_total counter",
                f"fastplaid_requests_total {self.requests}",
                "# TYPE fastplaid_queries_total counter",
                f"fastplaid_queries_total {self.queries}",
                "# TYPE fastplaid_dispatches_total counter",
                f"fastplaid_dispatches_total {self.dispatches}",
                "# TYPE fastplaid_errors_total counter",
                f"fastplaid_errors_total {self.errors}",
                "# TYPE fastplaid_lane_requests_total counter",
            ]
            for name, i in LANES.items():
                lines.append(
                    "fastplaid_lane_requests_total"
                    f'{{lane="{name}"}} {self.lane_requests[i]}'
                )
            lines.append("# TYPE fastplaid_request_latency_seconds histogram")
            cum = 0
            for edge, count in zip(LATENCY_BUCKETS, self.latency_buckets):
                cum += count
                lines.append(
                    "fastplaid_request_latency_seconds_bucket"
                    f'{{le="{edge}"}} {cum}'
                )
            cum += self.latency_buckets[-1]
            lines.append(
                'fastplaid_request_latency_seconds_bucket{le="+Inf"} ' f"{cum}"
            )
            lines.append(
                f"fastplaid_request_latency_seconds_sum {self.latency_sum_s:.6f}"
            )
            lines.append(f"fastplaid_request_latency_seconds_count {cum}")
            return "\n".join(lines) + "\n"


class _Pending:
    __slots__ = ("queries", "subsets", "future", "n", "t_submit")

    def __init__(self, queries, subsets, future):
        self.queries = queries  # list of [Lq, D] arrays
        self.subsets = subsets  # list[list[int]] | None (aligned) or None
        self.future = future
        self.n = len(queries)
        self.t_submit = time.perf_counter()


class MicroBatcher:
    """Coalesce search requests; one engine.search per (params) group.

    ``search_fn(queries, subsets, params_key) -> list`` runs the actual
    search; ``params_key`` is the hashable parameter tuple the requests
    were grouped by. ``submit(..., lane=1)`` routes a request to the
    lower-priority batch lane.
    """

    def __init__(
        self,
        search_fn,
        *,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
    ):
        self._search_fn = search_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.stats = BatchStats()
        # One FIFO queue dict per lane; lane 0 always drains first.
        self._queues: list[dict[tuple, list[_Pending]]] = [{}, {}]
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="fastplaid-batcher", daemon=True
        )
        self._thread.start()

    def submit(
        self, queries, params_key: tuple, subsets=None, lane: int = 0
    ) -> Future:
        """Enqueue a request; resolves to its list of per-query results."""
        fut: Future = Future()
        pend = _Pending(list(queries), subsets, fut)
        lane = 1 if lane else 0
        with self._cv:
            if self._closed:
                msg = "batcher is closed"
                raise RuntimeError(msg)
            self._queues[lane].setdefault(params_key, []).append(pend)
            self._cv.notify()
        return fut

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=5)

    # -- dispatcher -------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not any(self._queues) and not self._closed:
                    self._cv.wait()
                if self._closed and not any(self._queues):
                    return
            # Linger briefly so concurrent requests share the dispatch.
            if self.max_wait_s > 0:
                time.sleep(self.max_wait_s)
            with self._cv:
                lane = 0 if self._queues[0] else 1
                queues = self._queues[lane]
                if not queues:
                    continue
                key = next(iter(queues))
                batch: list[_Pending] = []
                total = 0
                q = queues[key]
                while q and total + q[0].n <= self.max_batch:
                    p = q.pop(0)
                    batch.append(p)
                    total += p.n
                if not batch and q:  # single oversized request
                    batch.append(q.pop(0))
                    total = batch[0].n
                if not q:
                    del queues[key]
            if not batch:
                continue
            self._dispatch(key, batch, total, lane)

    def _dispatch(
        self, key: tuple, batch: list[_Pending], total: int, lane: int
    ):
        queries = [qq for p in batch for qq in p.queries]
        subsets = None
        if any(p.subsets is not None for p in batch):
            subsets = []
            for p in batch:
                subsets.extend(
                    p.subsets if p.subsets is not None else [None] * p.n
                )
        try:
            results = self._search_fn(queries, subsets, key)
        except Exception as exc:  # propagate to every caller
            with self.stats._lock:
                self.stats.errors += len(batch)
            for p in batch:
                p.future.set_exception(exc)
            return
        done = time.perf_counter()
        self.stats.observe(
            len(batch), total, lane, [done - p.t_submit for p in batch]
        )
        off = 0
        for p in batch:
            p.future.set_result(results[off : off + p.n])
            off += p.n
