"""The scheduling core of the port: instances, US metric, GUS, scenarios,
the streaming arrival engine, QoS-class aggregation, congestion, policies
and the Monte-Carlo fleet, in PyTorch."""
from .aggregation import QuantizationConfig, aggregate_instance, aggregate_requests
from .gus import GUS_BACKENDS, Assignment, gus_schedule, gus_schedule_batch, gus_schedule_np
from .instance import (
    FlatInstance,
    GeneratorConfig,
    generate_batch,
    generate_instance,
    pad_instance,
    resolve_device,
    stack_instances,
)
from .options import EngineOptions, resolve_backend, resolve_options
from .policies import Policy, get_policy, list_policies, register_policy
from .queueing import CongestionConfig, PolicyCarry, committed_loads, fleet_policy_carry
from .satisfaction import hard_feasible, mean_us, satisfied_mask, us_tensor
from .scenarios import Scenario, get_scenario, list_scenarios, register_scenario
from .simulator import ClusterSpec, FleetResult, SimConfig, demo_cluster_spec, simulate_fleet
from .streaming import ArrivalStream, max_frame_arrivals, stream_trace, stream_trace_columns

__all__ = [
    "ArrivalStream",
    "Assignment",
    "ClusterSpec",
    "CongestionConfig",
    "EngineOptions",
    "FlatInstance",
    "FleetResult",
    "GUS_BACKENDS",
    "GeneratorConfig",
    "Policy",
    "PolicyCarry",
    "QuantizationConfig",
    "Scenario",
    "SimConfig",
    "aggregate_instance",
    "aggregate_requests",
    "committed_loads",
    "demo_cluster_spec",
    "fleet_policy_carry",
    "generate_batch",
    "generate_instance",
    "get_policy",
    "get_scenario",
    "gus_schedule",
    "gus_schedule_batch",
    "gus_schedule_np",
    "hard_feasible",
    "list_policies",
    "list_scenarios",
    "max_frame_arrivals",
    "mean_us",
    "pad_instance",
    "register_policy",
    "register_scenario",
    "resolve_backend",
    "resolve_device",
    "resolve_options",
    "satisfied_mask",
    "simulate_fleet",
    "stack_instances",
    "stream_trace",
    "stream_trace_columns",
    "us_tensor",
]
