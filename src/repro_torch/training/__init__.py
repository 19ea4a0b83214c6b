"""Synthetic data for the port (the training loop is not ported yet)."""
from .data import SyntheticLM, make_batch

__all__ = ["SyntheticLM", "make_batch"]
