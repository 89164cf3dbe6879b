"""The port's ColBERT encoders against the JAX package's, on the CPU.

Random BERT params made with numpy (2 layers, hidden 64, 4 heads, a 64 -> 32
head) go through JAX ``bert_forward`` and, carried across with
``params_from_jax``, through the port's: float32 within 1e-4 absolute on
every real token; bf16 products with a minimum token cosine of 0.99 (the
bound ``jax_encoder.py`` states for bf16). With ``transformers`` installed, a
tiny HF checkpoint written by the test (as ``test_jax_encoder.py`` writes
one) is loaded by both packages' ``load_bert_checkpoint`` (identical arrays)
and encoded by ``TorchColbertEncoder`` and ``JaxColbertEncoder`` at float32
(within 1e-4) and by the port's ``ColbertEncoder(device="cpu")`` (within
2e-4, the tolerance ``test_jax_encoder.py`` holds the HF model to). Last, the
whole slice at a small size: token ids encoded by each package, indexed by
each package's ``FastPlaid`` from one set of centroids, searched alike.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_plaid_tpu.models import jax_encoder as jenc
from fast_plaid_tpu_torch.models import torch_encoder as tenc

torch.set_num_threads(2)

CONFIG = {
    "hidden_size": 64,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 128,
    "vocab_size": 100,
    "max_position_embeddings": 64,
    "type_vocab_size": 2,
    "layer_norm_eps": 1e-12,
}
PROJ = 32
F32_TOL = 1e-4
BF16_MIN_COS = 0.99


def random_params(seed: int, projection: bool = True) -> dict:
    """The JAX package's params layout (dense w [in, out]) as numpy arrays."""
    rng = np.random.default_rng(seed)
    h, inter = CONFIG["hidden_size"], CONFIG["intermediate_size"]

    def normal(*shape, std=0.1):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def dense(n_in, n_out):
        return {"w": normal(n_in, n_out), "b": normal(n_out, std=0.02)}

    def ln(n):
        return {"g": 1.0 + normal(n), "b": normal(n, std=0.02)}

    layers = [
        {
            "q": dense(h, h),
            "k": dense(h, h),
            "v": dense(h, h),
            "attn_out": dense(h, h),
            "attn_ln": ln(h),
            "ffn_in": dense(h, inter),
            "ffn_out": dense(inter, h),
            "ffn_ln": ln(h),
        }
        for _ in range(CONFIG["num_hidden_layers"])
    ]
    return {
        "word_emb": normal(CONFIG["vocab_size"], h, std=0.5),
        "pos_emb": normal(CONFIG["max_position_embeddings"], h, std=0.5),
        "type_emb": normal(CONFIG["type_vocab_size"], h, std=0.5),
        "emb_ln": ln(h),
        "layers": layers,
        "projection": normal(h, PROJ, std=0.2) if projection else None,
    }


def padded_batch(seed: int, lens=(12, 5, 9, 1)):
    rng = np.random.default_rng(seed)
    sl = max(lens)
    ids = rng.integers(5, CONFIG["vocab_size"], (len(lens), sl)).astype(np.int32)
    mask = (np.arange(sl) < np.asarray(lens)[:, None]).astype(np.int32)
    return ids, mask


def jax_forward(params, ids, mask, dtype):
    out = jenc.bert_forward(
        params, ids, mask, n_heads=CONFIG["num_attention_heads"],
        ln_eps=CONFIG["layer_norm_eps"], compute_dtype=dtype,
    )
    return np.asarray(out)


def torch_forward(model, ids, mask, dtype):
    with torch.inference_mode():
        out = tenc.bert_forward(
            model, torch.from_numpy(ids), torch.from_numpy(mask), compute_dtype=dtype
        )
    return out.numpy()


def real_tokens(vecs, mask):
    return vecs[mask.astype(bool)]


def min_cosine(a, b) -> float:
    return float(np.sum(a * b, axis=-1).min())  # unit vectors


@pytest.mark.parametrize("projection", [True, False])
def test_bert_forward_f32_matches_jax(projection):
    params = random_params(0, projection)
    model = tenc.params_from_jax(params, CONFIG, device="cpu")
    ids, mask = padded_batch(1)
    want = real_tokens(jax_forward(params, ids, mask, jnp.float32), mask)
    got = real_tokens(torch_forward(model, ids, mask, torch.float32), mask)
    assert got.shape == want.shape == (int(mask.sum()), PROJ if projection else 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_bert_forward_bf16_matches_jax():
    """bf16 products (f32 results): each package's bf16 forward against the
    other's and against the float32 forward, token cosine >= 0.99."""
    params = random_params(2)
    model = tenc.params_from_jax(params, CONFIG, device="cpu")
    ids, mask = padded_batch(3, lens=(16, 7, 11))
    j16 = real_tokens(jax_forward(params, ids, mask, jnp.bfloat16), mask)
    j32 = real_tokens(jax_forward(params, ids, mask, jnp.float32), mask)
    t16 = real_tokens(torch_forward(model, ids, mask, torch.bfloat16), mask)
    assert t16.dtype == np.float32
    assert min_cosine(t16, j16) >= BF16_MIN_COS
    assert min_cosine(t16, j32) >= BF16_MIN_COS
    assert not np.array_equal(t16, j32)  # the bf16 products did round


def test_padding_does_not_change_real_tokens():
    """A sequence alone equals the same sequence inside a padded batch."""
    params = random_params(4)
    model = tenc.params_from_jax(params, CONFIG, device="cpu")
    ids, mask = padded_batch(5)
    batch = torch_forward(model, ids, mask, torch.float32)
    n = int(mask[1].sum())
    alone = torch_forward(model, ids[1:2, :n], mask[1:2, :n], torch.float32)
    np.testing.assert_allclose(alone[0], batch[1, :n], rtol=0, atol=1e-5)


def test_params_from_jax_checks_shapes():
    params = random_params(6)
    params["layers"][1]["ffn_in"]["w"] = params["layers"][1]["ffn_in"]["w"][:, :64]
    with pytest.raises(ValueError, match="shape"):
        tenc.params_from_jax(params, CONFIG, device="cpu")
    params = random_params(6)
    params["layers"] = params["layers"][:1]
    with pytest.raises(ValueError, match="layers"):
        tenc.params_from_jax(params, CONFIG, device="cpu")


def test_bert_colbert_holds_params_without_gradients():
    model = tenc.params_from_jax(random_params(7), CONFIG, device="cpu", dtype=torch.float32)
    assert model.word_emb.device.type == "cpu"
    assert not any(p.requires_grad for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    h, i, v, pos = 64, 128, 100, 64
    per_layer = 4 * (h * h + h) + (h * i + i) + (i * h + h) + 4 * h
    assert n_params == v * h + pos * h + 2 * h + 2 * h + 2 * per_layer + h * PROJ


# ---------------------------------------------------------------------------
# HF checkpoints (transformers installed).
# ---------------------------------------------------------------------------

TEXTS = [
    "a tiny document about token level retrieval",
    "another text, with punctuation! and more words than the first one",
    "short",
]


@pytest.fixture(scope="module", params=["safetensors", "bin"])
def tiny_ckpt(request, tmp_path_factory):
    """A random BertModel saved as ``model.safetensors`` with ``linear.weight``
    inside it, or as ``pytorch_model.bin`` with ``colbert_linear.pt`` beside it."""
    pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, BertTokenizerFast

    path = tmp_path_factory.mktemp(f"tiny_bert_{request.param}")
    torch.manual_seed(0)
    config = BertConfig(
        vocab_size=200,
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=64,
        max_position_embeddings=64,
    )
    model = BertModel(config).eval()
    proj = torch.randn(16, config.hidden_size) * 0.1
    if request.param == "safetensors":
        from safetensors.torch import save_file

        model.save_pretrained(path, safe_serialization=True)
        state = {k: v.contiguous() for k, v in model.state_dict().items()}
        state["linear.weight"] = proj
        save_file(state, str(path / "model.safetensors"), metadata={"format": "pt"})
    else:
        model.save_pretrained(path, safe_serialization=False)
        torch.save(proj, path / "colbert_linear.pt")

    words = sorted({w for t in TEXTS for w in t.lower().split()})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += ["[", "]", "q", "d", "!", ","] + words
    vocab_file = path / "vocab.txt"
    vocab_file.write_text("\n".join(vocab))
    BertTokenizerFast(str(vocab_file)).save_pretrained(path)
    assert (path / ("model.safetensors" if request.param == "safetensors" else "pytorch_model.bin")).exists()
    return str(path)


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_load_bert_checkpoint_matches_jax(tiny_ckpt):
    p_t, c_t = tenc.load_bert_checkpoint(tiny_ckpt)
    p_j, c_j = jenc.load_bert_checkpoint(tiny_ckpt)
    assert c_t == c_j
    assert p_t["projection"] is not None and p_t["projection"].shape == (32, 16)
    _assert_same_tree(p_t, p_j)


def _encoders(path, **kw):
    from fast_plaid_tpu.models.jax_encoder import JaxColbertEncoder
    from fast_plaid_tpu_torch.models import TorchColbertEncoder

    t = TorchColbertEncoder(path, compute_dtype=torch.float32, device="cpu", **kw)
    j = JaxColbertEncoder(path, compute_dtype=jnp.float32, **kw)
    return t, j


@pytest.mark.parametrize("kind", ["documents", "queries", "query_augment"])
def test_encode_matches_jax(tiny_ckpt, kind):
    kw = {"query_augment": True, "query_length": 16} if kind == "query_augment" else {}
    t, j = _encoders(tiny_ckpt, **kw)
    is_query = kind != "documents"
    got = t.encode(TEXTS, is_query=is_query, batch_size=2)
    want = j.encode(TEXTS, is_query=is_query, batch_size=2)
    assert len(got) == len(want) == len(TEXTS)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL)
    if kind == "query_augment":
        assert all(g.shape[0] >= 16 for g in got)


def test_colbert_encoder_matches_both(tiny_ckpt):
    from fast_plaid_tpu_torch.models import ColbertEncoder

    hf = ColbertEncoder(tiny_ckpt, device="cpu").encode(TEXTS)
    t, j = _encoders(tiny_ckpt)
    for h, a, b in zip(hf, t.encode(TEXTS), j.encode(TEXTS)):
        assert h.shape == a.shape == b.shape
        np.testing.assert_allclose(h, a, rtol=0, atol=2e-4)
        np.testing.assert_allclose(h, b, rtol=0, atol=2e-4)


def test_encode_ids_matches_encode(tiny_ckpt):
    """The text-free entry point: the tokenizer's ids through ``encode_ids``
    (batched longest first) equal ``encode`` of the texts, in input order."""
    t, _ = _encoders(tiny_ckpt)
    texts = TEXTS + [TEXTS[0] + " short"]
    seqs = [t.tokenizer(t.document_prefix + x)["input_ids"] for x in texts]
    got = t.encode_ids(seqs, batch_size=3)
    want = t.encode(texts, batch_size=3)
    for g, w, s in zip(got, want, seqs):
        assert g.shape == (len(s), 16)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="max_length"):
        t.encode_ids([list(range(5, 5 + t.max_length + 1))])


# ---------------------------------------------------------------------------
# A checkpoint written without transformers, and the slice: encode -> create
# -> search, in both packages.
# ---------------------------------------------------------------------------


def write_checkpoint(path, params) -> str:
    """``params`` in HF BERT names as ``pytorch_model.bin`` + ``config.json``
    (the ColBERT head as ``linear.weight``), written with torch alone."""
    import json

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    state = {
        "embeddings.word_embeddings.weight": t(params["word_emb"]),
        "embeddings.position_embeddings.weight": t(params["pos_emb"]),
        "embeddings.token_type_embeddings.weight": t(params["type_emb"]),
        "embeddings.LayerNorm.weight": t(params["emb_ln"]["g"]),
        "embeddings.LayerNorm.bias": t(params["emb_ln"]["b"]),
        "linear.weight": t(params["projection"].T),
    }
    names = {
        "q": "attention.self.query", "k": "attention.self.key",
        "v": "attention.self.value", "attn_out": "attention.output.dense",
        "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
        "attn_ln": "attention.output.LayerNorm", "ffn_ln": "output.LayerNorm",
    }
    for i, lp in enumerate(params["layers"]):
        for key, hf in names.items():
            p = f"encoder.layer.{i}.{hf}"
            if key.endswith("ln"):
                state[f"{p}.weight"], state[f"{p}.bias"] = t(lp[key]["g"]), t(lp[key]["b"])
            else:
                state[f"{p}.weight"], state[f"{p}.bias"] = t(lp[key]["w"].T), t(lp[key]["b"])
    torch.save({f"bert.{k}" if k != "linear.weight" else k: v for k, v in state.items()},
               str(path / "pytorch_model.bin"))
    (path / "config.json").write_text(json.dumps(CONFIG))
    return str(path)


def test_checkpoint_loads_without_safetensors_or_transformers(tmp_path, monkeypatch):
    """``pytorch_model.bin`` (with a ``bert.`` scope) loads through
    ``torch.load`` alone, into the same params, and encodes token ids."""
    import sys

    from fast_plaid_tpu_torch.models import TorchColbertEncoder

    params = random_params(9)
    path = write_checkpoint(tmp_path, params)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    loaded, config = tenc.load_bert_checkpoint(path)
    assert config == CONFIG
    _assert_same_tree(loaded, params)
    enc = TorchColbertEncoder(path, compute_dtype=torch.float32, device="cpu", max_length=64)
    ids, mask = padded_batch(10, lens=(9, 4))
    want = jax_forward(params, ids, mask, jnp.float32)
    got = enc.encode_ids([row[m.astype(bool)] for row, m in zip(ids, mask)])
    for g, w, m in zip(got, want, mask):
        np.testing.assert_allclose(g, w[m.astype(bool)], rtol=0, atol=F32_TOL)


def _jax_encode_ids(params, seqs, batch_size=16):
    out = []
    for s in range(0, len(seqs), batch_size):
        batch = seqs[s : s + batch_size]
        sl = max(len(x) for x in batch)
        ids = np.zeros((len(batch), sl), np.int32)
        mask = np.zeros((len(batch), sl), np.int32)
        for i, x in enumerate(batch):
            ids[i, : len(x)], mask[i, : len(x)] = x, 1
        vecs = jax_forward(params, ids, mask, jnp.float32)
        out += [vecs[i][mask[i].astype(bool)] for i in range(len(batch))]
    return out


def test_encode_index_search_matches_jax(tmp_path, monkeypatch):
    """Token ids (CLS 2 ... SEP 3) encoded at float32 by each package,
    indexed by each package's ``FastPlaid(device="cpu")`` from the same
    centroids, searched with random and planted queries: top-10 equal up
    to score ties, planted documents first."""
    from fast_plaid_tpu.search import fast_plaid as jfp
    from fast_plaid_tpu_torch.models import TorchColbertEncoder
    from fast_plaid_tpu_torch.search import fast_plaid as tfp

    rng = np.random.default_rng(11)
    lens = rng.integers(8, 25, 120)
    docs = [np.concatenate([[2], rng.integers(5, 100, n - 2), [3]]) for n in lens]
    planted = [0, 57, 119]
    queries = [np.concatenate([[2], rng.integers(5, 100, 6), [3]]) for _ in range(5)]
    queries += [docs[p][:8] for p in planted]
    params = random_params(8)

    (tmp_path / "ckpt").mkdir()
    path = write_checkpoint(tmp_path / "ckpt", params)
    enc = TorchColbertEncoder(path, compute_dtype=torch.float32, device="cpu", max_length=64)
    t_docs, t_q = enc.encode_ids(docs), enc.encode_ids(queries)
    j_docs, j_q = _jax_encode_ids(params, docs), _jax_encode_ids(params, queries)
    for a, b in zip(t_docs + t_q, j_docs + j_q):
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL)

    flat = np.concatenate(t_docs)
    cent = flat[:: max(1, len(flat) // 64)][:64].copy()  # one set for both packages

    def fixed_kmeans(*_a, **_kw):
        return cent.copy()

    monkeypatch.setattr(jfp, "compute_kmeans", fixed_kmeans)
    monkeypatch.setattr(tfp, "compute_kmeans", fixed_kmeans)
    kw = dict(top_k=10, show_progress=False)
    tp = tfp.FastPlaid(str(tmp_path / "t"), device="cpu")
    tp.create(documents_embeddings=t_docs)
    jp = jfp.FastPlaid(str(tmp_path / "j"), device="cpu")
    jp.create(documents_embeddings=j_docs)
    q_len = max(len(q) for q in queries)

    def pad(qs):
        out = np.zeros((len(qs), q_len, PROJ), np.float32)
        for i, q in enumerate(qs):
            out[i, : len(q)] = q
        return out

    rt, rj = tp.search(pad(t_q), **kw), jp.search(pad(j_q), **kw)
    assert [r[0][0] for r in rt[-3:]] == planted == [r[0][0] for r in rj[-3:]]
    tol = 1e-3  # float32 forwards 1e-4 apart, summed over a query's tokens
    for a, b in zip(rt, rj):
        ia, sa = [p for p, _ in a], np.asarray([s for _, s in a])
        ib, sb = [p for p, _ in b], np.asarray([s for _, s in b])
        np.testing.assert_allclose(sa, sb, rtol=0, atol=tol)
        for j, pid in enumerate(ia):
            if pid not in ib:
                assert abs(sa[j] - sa[-1]) <= tol
