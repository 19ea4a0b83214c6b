"""PyTorch + CUDA port of the edge accuracy-time trade-off system.

A second package beside the JAX reference (``repro``): the same scheduler
simulation in PyTorch, with the GUS kernel hand-written for NVIDIA Hopper
(``kernels/csrc/gus_assign.cu``).  It imports neither ``jax`` nor anything
of ``repro``.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
