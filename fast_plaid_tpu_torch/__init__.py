"""fast_plaid_tpu_torch — the PLAID engine in PyTorch, for one NVIDIA H100.

The port of ``fast_plaid_tpu`` (JAX/XLA/Pallas), module for module: the
same on-disk index format (``layout_version: 1``), the same search cascade
and the same public API. Plain tensor code is PyTorch; each Pallas kernel of
the JAX package is a CUDA C++ kernel for ``sm_90a`` (``csrc/``), built with
nvcc at first use and bound through ctypes.

    from fast_plaid_tpu_torch import search
    engine = search.FastPlaid(index="index_dir", device="cuda")
    engine.create(documents_embeddings=[...])
    engine.search(queries_embeddings=...)

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from fast_plaid_tpu_torch import filtering, search  # noqa: E402,F401

__all__ = ["search", "filtering", "__version__"]
