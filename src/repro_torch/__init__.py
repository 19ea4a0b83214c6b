"""PyTorch + CUDA port of the edge accuracy-time trade-off system.

A second package beside the JAX reference (``repro``): the same scheduler
simulation in PyTorch — the dense Monte-Carlo fleet and the city-scale
hierarchical class-aggregate fleet, with materialized or streamed arrivals —
with the GUS kernel and the class allocator hand-written for NVIDIA Hopper
(``kernels/csrc/gus_assign.cu``, ``kernels/csrc/hier_cells.cu``).  It
imports neither ``jax`` nor anything of ``repro``.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
