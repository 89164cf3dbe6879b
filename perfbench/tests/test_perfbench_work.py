"""The work arithmetic against hand counts on a few rows."""

import pytest
import torch

from perfbench import work


def test_bound_takes_the_larger_time():
    ms, by = work.bound(3.35e12, 1.0, work.BF16_OPS)
    assert ms == pytest.approx(1000.0) and by == "bytes"
    ms, by = work.bound(1.0, 989e12, work.BF16_OPS)
    assert ms == pytest.approx(1000.0) and by == "operations"


def test_rerank_work_counts_distinct_rows_once():
    d, q = 8, 4
    pids = torch.tensor([[0, 1, 1, 5]], dtype=torch.int32)  # 5 is out of range
    lens = torch.tensor([[2, 3, 3, 4]], dtype=torch.int32)
    queries = torch.zeros((1, q, d))
    w = work.rerank_work(pids, lens, queries, n_docs=4, cap=16, d=d)
    rows = 2 + 3  # doc 0: 2 rows, doc 1: 3 rows read once; pid 5 empty
    io = 4 * 12 + q * d * 2
    assert w["bytes"] == rows * 2 * d + io
    assert w["ops"] == 2 * q * d * (2 + 3 + 3)  # every valid token of every slot


def test_rerank_work_longest_length_asked_of_a_document():
    pids = torch.tensor([[2, 2]], dtype=torch.int32)
    lens = torch.tensor([[3, 7]], dtype=torch.int32)
    w = work.rerank_work(pids, lens, torch.zeros((1, 2, 4)), n_docs=3, cap=16, d=4)
    assert w["bytes"] == 7 * 2 * 4 + 2 * 12 + 2 * 4 * 2


def test_rerank_work_q4_half_cap_and_clamped_pids():
    d, q = 8, 2
    pids = torch.tensor([[0, 9]], dtype=torch.int32)  # 9 clamps to the last row, 3
    lens = torch.tensor([[10, 3]], dtype=torch.int32)
    w = work.rerank_work(pids, lens, torch.zeros((1, q, d)), n_docs=4, cap=16, d=d, q4_half=8)
    rows = min(10, 8) + 3  # packed rows: at most caph of them
    assert w["bytes"] == rows * d + 4 * 2 + 2 * 12 + q * d * 2
    assert w["ops"] == 2 * q * d * (10 + 3)


def test_estimate_work():
    pid = torch.zeros((2, 5), dtype=torch.int32)
    tbl = torch.zeros((2, 3, 4))
    w = work.estimate_work(pid, pid, tbl)
    assert w["bytes"] == 10 * 12 + 24 * 2
    assert w["ops"] == 10 * 4
