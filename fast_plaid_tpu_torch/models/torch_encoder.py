"""ColBERT encoder in PyTorch: a BERT forward over HF checkpoints, on the card.

The counterpart of ``fast_plaid_tpu/models/jax_encoder.py``. It loads
standard HuggingFace BERT-family checkpoints (``config.json`` +
``model.safetensors`` / ``pytorch_model.bin``) with no ``transformers`` in
the load or the forward, applies the ColBERT linear head where the
checkpoint ships one, and L2-normalizes every token vector.

The forward (``bert_forward``) reproduces the JAX one operation for
operation: post-LN BERT with LayerNorm statistics in float32, an additive
-1e9 padding bias before the softmax, erf GELU, token type 0 only, the
projection, then ``h / max(|h|, 1e-12)``. Every dense product and both
attention products take ``compute_dtype`` inputs (bf16 by default) and give
float32 results: on the card through ``torch.mm`` / ``torch.bmm`` with
``out_dtype=torch.float32`` where the installed PyTorch offers it (else the
bf16 result is cast), on the CPU as a float32 product of the bf16-rounded
inputs. The products are plain PyTorch calls, as the JAX
package leaves them to XLA; no fused attention call is used, since its
softmax would differ from the reference's.

Tokenization stays on the host (``AutoTokenizer``, imported at first use);
``encode_ids`` takes token ids and needs no tokenizer.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fast_plaid_tpu_torch.utils.devices import default_device

__all__ = [
    "BertColbert",
    "TorchColbertEncoder",
    "bert_forward",
    "load_bert_checkpoint",
    "params_from_jax",
]

# torch.mm / torch.bmm with out_dtype (bf16 in, float32 out) on CUDA.
F32_OUT = "dtype" in torch.ops.aten.mm.overloads() and "dtype" in torch.ops.aten.bmm.overloads()


# ---------------------------------------------------------------------------
# Checkpoint loading: HF tensor names -> the JAX package's params layout.
# ---------------------------------------------------------------------------


def _read_tensors(path: str) -> dict[str, np.ndarray]:
    """Read all tensors from an HF checkpoint directory as numpy arrays:
    ``model.safetensors`` through ``safetensors`` where it imports, else
    ``pytorch_model.bin`` through ``torch.load(weights_only=True)``."""
    st = os.path.join(path, "model.safetensors")
    pt = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st):
        try:
            from safetensors.numpy import load_file
        except ImportError:
            if not os.path.exists(pt):
                raise
        else:
            return load_file(st)
    if os.path.exists(pt):
        state = torch.load(pt, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in state.items()}
    msg = f"no model.safetensors or pytorch_model.bin under {path!r}"
    raise FileNotFoundError(msg)


def _strip_prefix(tensors: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Drop a leading 'bert.' / 'model.' scope if every key carries it."""
    for prefix in ("bert.", "model."):
        if all(
            k.startswith(prefix) or "." not in k or k.startswith("linear")
            for k in tensors
        ) and any(k.startswith(prefix) for k in tensors):
            return {
                (k[len(prefix) :] if k.startswith(prefix) else k): v
                for k, v in tensors.items()
            }
    return tensors


def load_bert_checkpoint(path: str) -> tuple[dict, dict]:
    """Load (params, config) from an HF BERT checkpoint directory.

    ``params`` is the JAX package's layout, as numpy arrays: dense kernels
    pre-transposed to [in, out] ({"w", "b"}), LayerNorms as {"g", "b"}, the
    ColBERT head under "projection" ([hidden, dim], looked up as
    ``linear.weight`` / ``colbert_linear.weight`` in the checkpoint or as
    ``colbert_linear.pt`` / ``linear.pt`` beside it) or None.
    ``params_from_jax`` turns it into a ``BertColbert``.
    """
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    raw = _strip_prefix(_read_tensors(path))

    def dense(name: str) -> dict:
        return {"w": raw[f"{name}.weight"].T.copy(), "b": raw[f"{name}.bias"]}

    def ln(name: str) -> dict:
        return {"g": raw[f"{name}.weight"], "b": raw[f"{name}.bias"]}

    layers = []
    for i in range(int(config["num_hidden_layers"])):
        p = f"encoder.layer.{i}"
        layers.append(
            {
                "q": dense(f"{p}.attention.self.query"),
                "k": dense(f"{p}.attention.self.key"),
                "v": dense(f"{p}.attention.self.value"),
                "attn_out": dense(f"{p}.attention.output.dense"),
                "attn_ln": ln(f"{p}.attention.output.LayerNorm"),
                "ffn_in": dense(f"{p}.intermediate.dense"),
                "ffn_out": dense(f"{p}.output.dense"),
                "ffn_ln": ln(f"{p}.output.LayerNorm"),
            }
        )

    projection = None
    for key in ("linear.weight", "colbert_linear.weight"):
        if key in raw:
            projection = raw[key].T.copy()  # [hidden, dim]
            break
    if projection is None:
        for fname in ("colbert_linear.pt", "linear.pt"):
            fpath = os.path.join(path, fname)
            if os.path.exists(fpath):
                head = torch.load(fpath, map_location="cpu", weights_only=True)
                projection = head.numpy().T.copy()
                break

    params = {
        "word_emb": raw["embeddings.word_embeddings.weight"],
        "pos_emb": raw["embeddings.position_embeddings.weight"],
        "type_emb": raw["embeddings.token_type_embeddings.weight"],
        "emb_ln": ln("embeddings.LayerNorm"),
        "layers": layers,
        "projection": projection,
    }
    return params, config


# ---------------------------------------------------------------------------
# The module.
# ---------------------------------------------------------------------------


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, **f) -> None:
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_in, n_out, **f))  # [in, out]
        self.b = nn.Parameter(torch.empty(n_out, **f))


class _LayerNorm(nn.Module):
    def __init__(self, n: int, **f) -> None:
        super().__init__()
        self.g = nn.Parameter(torch.empty(n, **f))
        self.b = nn.Parameter(torch.empty(n, **f))


class _Layer(nn.Module):
    def __init__(self, hidden: int, inter: int, **f) -> None:
        super().__init__()
        self.q = _Dense(hidden, hidden, **f)
        self.k = _Dense(hidden, hidden, **f)
        self.v = _Dense(hidden, hidden, **f)
        self.attn_out = _Dense(hidden, hidden, **f)
        self.attn_ln = _LayerNorm(hidden, **f)
        self.ffn_in = _Dense(hidden, inter, **f)
        self.ffn_out = _Dense(inter, hidden, **f)
        self.ffn_ln = _LayerNorm(hidden, **f)


class BertColbert(nn.Module):
    """BERT encoder + ColBERT projection head, in the JAX package's params
    layout (dense weights [in, out]). Parameters start uninitialized on
    ``device`` (None: the CUDA card, raising without one) in ``dtype``;
    ``params_from_jax`` fills them. Inference only: no gradients."""

    def __init__(
        self,
        config: dict,
        projection_dim: int | None,
        *,
        device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        f = {"device": default_device(device), "dtype": dtype}
        hidden = int(config["hidden_size"])
        self.n_heads = int(config["num_attention_heads"])
        self.ln_eps = float(config.get("layer_norm_eps", 1e-12))
        self.word_emb = nn.Parameter(torch.empty(int(config["vocab_size"]), hidden, **f))
        self.pos_emb = nn.Parameter(
            torch.empty(int(config["max_position_embeddings"]), hidden, **f)
        )
        self.type_emb = nn.Parameter(torch.empty(int(config.get("type_vocab_size", 2)), hidden, **f))
        self.emb_ln = _LayerNorm(hidden, **f)
        self.layers = nn.ModuleList(
            _Layer(hidden, int(config["intermediate_size"]), **f)
            for _ in range(int(config["num_hidden_layers"]))
        )
        self.projection = (
            None if projection_dim is None else nn.Parameter(torch.empty(hidden, projection_dim, **f))
        )
        self.requires_grad_(False)

    def forward(self, input_ids, attention_mask, compute_dtype=torch.bfloat16):
        return bert_forward(self, input_ids, attention_mask, compute_dtype=compute_dtype)


def params_from_jax(
    params: dict,
    config: dict,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> BertColbert:
    """A ``BertColbert`` on ``device`` (None: the CUDA card) holding
    ``params``: the JAX package's params pytree as numpy arrays (what either
    package's ``load_bert_checkpoint`` returns; dense ``w`` [in, out])."""
    proj = params["projection"]
    model = BertColbert(
        config, None if proj is None else int(np.shape(proj)[1]), device=device, dtype=dtype
    )

    def put(param: nn.Parameter, value) -> None:
        value = torch.from_numpy(np.asarray(value, dtype=np.float32))
        if tuple(value.shape) != tuple(param.shape):
            msg = f"checkpoint shape {tuple(value.shape)} != model shape {tuple(param.shape)}"
            raise ValueError(msg)
        param.copy_(value)

    def put_dense(mod: _Dense, p: dict) -> None:
        put(mod.w, p["w"])
        put(mod.b, p["b"])

    def put_ln(mod: _LayerNorm, p: dict) -> None:
        put(mod.g, p["g"])
        put(mod.b, p["b"])

    with torch.no_grad():
        put(model.word_emb, params["word_emb"])
        put(model.pos_emb, params["pos_emb"])
        put(model.type_emb, params["type_emb"])
        put_ln(model.emb_ln, params["emb_ln"])
        if len(params["layers"]) != len(model.layers):
            msg = f"{len(params['layers'])} layers in params, {len(model.layers)} in config"
            raise ValueError(msg)
        for mod, lp in zip(model.layers, params["layers"]):
            for name in ("q", "k", "v", "attn_out", "ffn_in", "ffn_out"):
                put_dense(getattr(mod, name), lp[name])
            put_ln(mod.attn_ln, lp["attn_ln"])
            put_ln(mod.ffn_ln, lp["ffn_ln"])
        if proj is not None:
            put(model.projection, proj)
    return model


# ---------------------------------------------------------------------------
# Forward pass.
# ---------------------------------------------------------------------------


def _matmul(a: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """a @ b (2-D or batched 3-D) of ``compute_dtype`` inputs, float32 result."""
    if compute_dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    a, b = a.to(compute_dtype), b.to(compute_dtype)
    if a.is_cuda:
        if F32_OUT:
            mm = torch.mm if a.dim() == 2 else torch.bmm
            return mm(a, b, out_dtype=torch.float32)
        return torch.matmul(a, b).float()
    return torch.matmul(a.float(), b.float())  # bf16-rounded inputs, f32 sums


def _dense(x: torch.Tensor, p: _Dense, compute_dtype: torch.dtype) -> torch.Tensor:
    y = _matmul(x.reshape(-1, x.shape[-1]), p.w, compute_dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1]) + p.b.float()


def _layer_norm(x: torch.Tensor, p: _LayerNorm, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p.g.float(), p.b.float(), eps)


def bert_forward(
    model: BertColbert,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """HF BertModel.last_hidden_state + ColBERT projection + L2 norm.

    [B, L] ids + mask -> [B, L, dim] unit vectors (float32) on the model's
    device. Masked positions produce unspecified values: callers select by
    ``attention_mask``.
    """
    dev = model.word_emb.device
    ids = input_ids.to(dev, torch.long)
    mask = attention_mask.to(dev)
    b, sl = ids.shape
    h = (
        model.word_emb[ids].float()
        + model.pos_emb[:sl].float()[None, :, :]
        + model.type_emb[0].float()[None, None, :]
    )
    h = _layer_norm(h, model.emb_ln, model.ln_eps)

    # Additive attention bias: 0 for real tokens, -1e9 for padding.
    bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]  # [B, 1, 1, L]
    hidden = h.shape[-1]
    nh = model.n_heads
    hd = hidden // nh

    def split_heads(x):  # [B, L, H] -> [B * heads, L, head_dim]
        return x.reshape(b, sl, nh, hd).transpose(1, 2).reshape(b * nh, sl, hd)

    for lp in model.layers:
        q = split_heads(_dense(h, lp.q, compute_dtype))
        k = split_heads(_dense(h, lp.k, compute_dtype))
        v = split_heads(_dense(h, lp.v, compute_dtype))
        scores = (
            _matmul(q, k.transpose(1, 2), compute_dtype).reshape(b, nh, sl, sl)
            / math.sqrt(hd)
            + bias
        )
        att = torch.softmax(scores, dim=-1).reshape(b * nh, sl, sl)
        ctx = _matmul(att, v, compute_dtype)
        ctx = ctx.reshape(b, nh, sl, hd).transpose(1, 2).reshape(b, sl, hidden)
        h = _layer_norm(h + _dense(ctx, lp.attn_out, compute_dtype), lp.attn_ln, model.ln_eps)
        ffn = F.gelu(_dense(h, lp.ffn_in, compute_dtype), approximate="none")
        h = _layer_norm(h + _dense(ffn, lp.ffn_out, compute_dtype), lp.ffn_ln, model.ln_eps)

    if model.projection is not None:
        h = _matmul(h.reshape(b * sl, hidden), model.projection, compute_dtype).reshape(b, sl, -1)
    norm = torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    return h / torch.clamp_min(norm, 1e-12)


# ---------------------------------------------------------------------------
# The encoder.
# ---------------------------------------------------------------------------


class TorchColbertEncoder:
    """The counterpart of ``JaxColbertEncoder``: ``encode(texts, is_query,
    batch_size) -> list of [n_tokens, dim] float32``, the forward on
    ``device`` (None: the CUDA card, raising without one).

    Batches are padded to their longest sequence, not to the JAX package's
    power-of-two buckets (those exist to bound XLA compiles); outputs on
    real tokens do not depend on the padding.
    """

    def __init__(
        self,
        model_name_or_path: str,
        max_length: int = 300,
        query_prefix: str = "[Q] ",
        document_prefix: str = "[D] ",
        query_augment: bool = False,
        query_length: int = 32,
        compute_dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        self.path = str(model_name_or_path)
        params, self.config = load_bert_checkpoint(self.path)
        self.model = params_from_jax(params, self.config, device=device)
        self.device = self.model.word_emb.device
        self.max_length = max_length
        self.query_prefix = query_prefix
        self.document_prefix = document_prefix
        self.query_augment = query_augment
        self.query_length = query_length
        self.compute_dtype = torch.bfloat16 if compute_dtype is None else compute_dtype
        self._tokenizer = None

    @property
    def tokenizer(self):
        """The checkpoint's HF tokenizer, loaded at first use."""
        if self._tokenizer is None:
            from transformers import AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(self.path)
        return self._tokenizer

    def encode(
        self, texts: list[str], is_query: bool = False, batch_size: int = 32
    ) -> list[np.ndarray]:
        prefix = self.query_prefix if is_query else self.document_prefix
        out: list[np.ndarray] = []
        for start in range(0, len(texts), batch_size):
            batch = [prefix + t for t in texts[start : start + batch_size]]
            enc = self.tokenizer(
                batch,
                padding=True,
                truncation=True,
                max_length=self.max_length,
                return_tensors="np",
            )
            ids = enc["input_ids"].astype(np.int64)
            mask = enc["attention_mask"].astype(np.int64)
            if is_query and self.query_augment:
                ids, mask = self._augment(ids, mask)
            out.extend(self._forward(ids, mask))
        return out

    def encode_ids(self, sequences, batch_size: int = 32) -> list[np.ndarray]:
        """Token id sequences (special and prefix tokens included, every id a
        real token) -> one [len, dim] float32 array each, in input order.
        Batches are formed longest first, so padding stays small."""
        lens = np.asarray([len(s) for s in sequences], dtype=np.int64)
        if lens.size and int(lens.max()) > self.max_length:
            msg = f"a sequence of {int(lens.max())} ids exceeds max_length {self.max_length}"
            raise ValueError(msg)
        order = np.argsort(-lens, kind="stable")
        out: list[np.ndarray | None] = [None] * len(sequences)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            sl = int(lens[idx[0]])
            ids = np.zeros((len(idx), sl), dtype=np.int64)
            for row, i in enumerate(idx):
                ids[row, : lens[i]] = sequences[i]
            mask = (np.arange(sl) < lens[idx][:, None]).astype(np.int64)
            for i, vecs in zip(idx, self._forward(ids, mask)):
                out[i] = vecs
        return out

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> list[np.ndarray]:
        """One padded batch through the forward; the real tokens' vectors."""
        with torch.inference_mode():
            vecs = bert_forward(
                self.model,
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device),
                compute_dtype=self.compute_dtype,
            )
            if vecs.is_cuda:  # one copy into pinned memory, at the link's rate
                host = torch.empty(vecs.shape, dtype=vecs.dtype, pin_memory=True)
                vecs = host.copy_(vecs)
            vecs = vecs.cpu().numpy()
        keep = mask.astype(bool)
        return [vecs[i][keep[i]] for i in range(ids.shape[0])]

    def _augment(self, ids: np.ndarray, mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """ColBERT query augmentation: pad every query to ``query_length``
        with [MASK] tokens the model attends to."""
        mask_id = self.tokenizer.mask_token_id
        if mask_id is None:
            return ids, mask
        b, sl = ids.shape
        ql = max(self.query_length, sl)
        ids_a = np.full((b, ql), mask_id, ids.dtype)
        ids_a[:, :sl] = np.where(mask.astype(bool), ids, mask_id)
        return ids_a, np.ones((b, ql), mask.dtype)
