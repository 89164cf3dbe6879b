"""Optional encoders: token ids or texts in, per-token ColBERT vectors out.

The engine itself is model-agnostic: it indexes and searches multi-vector
embeddings from any late-interaction model. Two interchangeable encoders
over HuggingFace BERT checkpoints, as in ``fast_plaid_tpu/models``:
``ColbertEncoder`` (a ``transformers`` wrapper) and ``TorchColbertEncoder``
(the port's own BERT forward, ``BertColbert``, on the card, loading
checkpoints with no ``transformers``). Nothing here imports
``transformers`` until an encoder needs a tokenizer or an HF model.
"""

from fast_plaid_tpu_torch.models.encoder import ColbertEncoder
from fast_plaid_tpu_torch.models.torch_encoder import (
    BertColbert,
    TorchColbertEncoder,
    bert_forward,
    load_bert_checkpoint,
    params_from_jax,
)

__all__ = [
    "ColbertEncoder",
    "TorchColbertEncoder",
    "BertColbert",
    "bert_forward",
    "load_bert_checkpoint",
    "params_from_jax",
]
