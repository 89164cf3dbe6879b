"""Minimal ColBERT-style multi-vector encoder over ``transformers`` (optional).

A copy of ``fast_plaid_tpu/models/encoder.py``: wraps a HuggingFace
transformer to emit one L2-normalized vector per token, applying the
checkpoint's ColBERT linear head (``linear.weight``) where it ships one.
The one change: the model runs on the CUDA card unless ``device="cpu"`` is
asked for, and raises without one. ``transformers`` is imported only when
an encoder is built. ``TorchColbertEncoder`` (``models/torch_encoder.py``)
computes the same vectors with no ``transformers`` in the forward.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fast_plaid_tpu_torch.utils.devices import default_device

__all__ = ["ColbertEncoder"]


class ColbertEncoder:
    """Encode texts to [n_tokens, dim] float32 arrays, one per text."""

    def __init__(
        self,
        model_name_or_path: str,
        device: torch.device | str | None = None,
        max_length: int = 300,
        query_prefix: str = "[Q] ",
        document_prefix: str = "[D] ",
    ) -> None:
        device = default_device(device)
        try:
            from transformers import AutoModel, AutoTokenizer
        except ImportError as exc:
            msg = "ColbertEncoder requires transformers."
            raise ImportError(msg) from exc

        self.tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
        self.model = AutoModel.from_pretrained(model_name_or_path)
        self.model.eval().to(device)
        self.device = device
        self.max_length = max_length
        self.query_prefix = query_prefix
        self.document_prefix = document_prefix
        self.projection = self._load_projection(model_name_or_path)

    def _load_projection(self, model_name_or_path: str):
        """The ColBERT linear head (linear.weight) where the checkpoint
        provides one; otherwise None (identity)."""
        for fname in ("colbert_linear.pt", "linear.pt"):
            path = os.path.join(str(model_name_or_path), fname)
            if os.path.exists(path):
                return torch.load(path, map_location="cpu", weights_only=True)
        try:
            from safetensors import safe_open
        except ImportError:
            return None
        path = os.path.join(str(model_name_or_path), "model.safetensors")
        if os.path.exists(path):
            with safe_open(path, framework="pt") as f:
                for key in ("linear.weight", "colbert_linear.weight"):
                    if key in f.keys():
                        return f.get_tensor(key)
        return None

    def encode(
        self, texts: list[str], is_query: bool = False, batch_size: int = 16
    ) -> list[np.ndarray]:
        prefix = self.query_prefix if is_query else self.document_prefix
        out: list[np.ndarray] = []
        with torch.inference_mode():
            for start in range(0, len(texts), batch_size):
                batch = [prefix + t for t in texts[start : start + batch_size]]
                enc = self.tokenizer(
                    batch,
                    padding=True,
                    truncation=True,
                    max_length=self.max_length,
                    return_tensors="pt",
                ).to(self.device)
                hidden = self.model(**enc).last_hidden_state  # [B, L, H]
                if self.projection is not None:
                    hidden = hidden @ self.projection.T.to(hidden.device)
                hidden = torch.nn.functional.normalize(hidden, dim=-1)
                mask = enc["attention_mask"].bool()
                for i in range(hidden.shape[0]):
                    vecs = hidden[i][mask[i]]
                    out.append(vecs.cpu().numpy().astype(np.float32))
        return out
