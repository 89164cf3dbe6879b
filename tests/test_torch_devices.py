"""The port's public entry points run on the CUDA card unless the caller asks
for the CPU: with no device they raise on a host without CUDA (this one),
and with ``device="cpu"`` they run here. Whether a card exists is decided
inside each test."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fast_plaid_tpu_torch.index import to_device
from fast_plaid_tpu_torch.models import BertColbert, ColbertEncoder, params_from_jax
from fast_plaid_tpu_torch.search import compute_kmeans
from fast_plaid_tpu_torch.utils.devices import NO_CUDA, default_device

torch.set_num_threads(2)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")


def _docs(seed=0, n=40, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(4, 12)), d)).astype(np.float32) for _ in range(n)]


def test_default_device(no_cuda):
    with pytest.raises(RuntimeError, match="No CUDA device available"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(torch.device("cpu")) == torch.device("cpu")


def test_compute_kmeans_needs_cuda_by_default(no_cuda):
    docs = _docs()
    with pytest.raises(RuntimeError) as exc:
        compute_kmeans(docs, dim=16, num_partitions=8)
    assert str(exc.value) == NO_CUDA
    cent = compute_kmeans(docs, dim=16, num_partitions=8, kmeans_niters=2, device="cpu")
    assert cent.shape == (8, 16) and cent.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(cent, axis=1), 1.0, atol=1e-5)


def test_to_device_needs_cuda_by_default(no_cuda):
    rng = np.random.default_rng(1)
    lens = np.asarray([3, 5, 2], np.int64)
    host = dict(
        centroids=rng.standard_normal((4, 8)).astype(np.float32),
        bucket_weights=np.linspace(-1, 1, 16).astype(np.float32),
        codes=rng.integers(0, 4, lens.sum()).astype(np.int32),
        residuals=rng.integers(0, 255, (lens.sum(), 4)).astype(np.uint8),
        doc_lengths=lens,
        ivf=None,
        ivf_lengths=None,
        nbits=4,
    )
    with pytest.raises(RuntimeError, match="No CUDA device available"):
        to_device(**host)
    dev, spec = to_device(**host, device="cpu")
    assert dev.codes.device.type == "cpu" and spec.n_docs >= 3


def test_encoders_need_cuda_by_default(no_cuda, tmp_path):
    config = {"hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
              "intermediate_size": 16, "vocab_size": 10, "max_position_embeddings": 8}
    with pytest.raises(RuntimeError, match="No CUDA device available"):
        BertColbert(config, 4)
    assert BertColbert(config, 4, device="cpu").word_emb.device.type == "cpu"
    with pytest.raises(RuntimeError, match="No CUDA device available"):
        params_from_jax({"projection": None}, config)
    with pytest.raises(RuntimeError, match="No CUDA device available"):
        ColbertEncoder(str(tmp_path))  # before transformers or a checkpoint is read
