"""The plain reference of the benchmark's configurations: PyTorch in
float32 with TF32 off, written from the published descriptions.  It
imports nothing of the program under test and takes none of its state:
only the weights and token ids that the benchmark made for both sides."""
from .model import logits_at

__all__ = ["logits_at"]
