"""SQLite metadata filtering (the API of ``fast_plaid_tpu.filtering``)."""

from fast_plaid_tpu_torch.filtering.filtering import create, delete, get, update, where

__all__ = ["create", "update", "delete", "get", "where"]
