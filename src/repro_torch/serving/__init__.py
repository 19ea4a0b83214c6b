"""Serving for the port: batched prefill + greedy decode, continuous
batching, and the analytic profiles and model zoo that price the
scheduler's variants."""
from .continuous import ContinuousBatcher, Request
from .engine import GenerationResult, ServingEngine, make_prefill_step, make_serve_step
from .profiles import HW_CLASSES, HardwareClass, accuracy_proxy, request_latency_ms, step_costs
from .zoo import ModelZoo, ServiceSpec, build_cluster_spec, variant_ladder

__all__ = [
    "HardwareClass", "HW_CLASSES", "step_costs", "request_latency_ms", "accuracy_proxy",
    "ServiceSpec", "ModelZoo", "variant_ladder", "build_cluster_spec",
    "ServingEngine", "make_serve_step", "make_prefill_step", "GenerationResult",
    "ContinuousBatcher", "Request",
]
