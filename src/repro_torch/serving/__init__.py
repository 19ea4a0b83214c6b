"""Serving for the port: batched prefill + greedy decode."""
from .engine import GenerationResult, ServingEngine, make_prefill_step, make_serve_step

__all__ = ["ServingEngine", "make_serve_step", "make_prefill_step", "GenerationResult"]
