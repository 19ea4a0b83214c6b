"""Model zoo — the paper's "|L| DL model types per service".

The port's copy of ``repro.serving.zoo``.  A :class:`ServiceSpec` owns a
ladder of model variants (configurations of increasing size, accuracy and
cost); :func:`build_cluster_spec` turns a zoo and a server layout into the
:class:`~repro_torch.core.simulator.ClusterSpec` whose T^proc and accuracy
tables the scheduler consumes.  Variant latency comes from the analytic
roofline profile (:mod:`.profiles`) or from measurements when given.
Numpy and Python only, the reference's operations in its order, so the
tables are equal bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..configs.base import ModelConfig
from ..core.simulator import ClusterSpec
from .profiles import HW_CLASSES, HardwareClass, accuracy_proxy, request_latency_ms

__all__ = ["ServiceSpec", "ModelZoo", "variant_ladder", "build_cluster_spec"]


@dataclasses.dataclass
class ServiceSpec:
    """One service (task type) with an accuracy/cost ladder of variants."""

    name: str
    variants: List[ModelConfig]                      # ordered cheap -> costly
    accuracy: Optional[List[float]] = None           # measured; else the proxy

    def accuracies(self) -> List[float]:
        if self.accuracy is not None:
            return list(self.accuracy)
        return [accuracy_proxy(v.n_params()) for v in self.variants]


def variant_ladder(base: ModelConfig, n_variants: int, min_scale: float = 0.12) -> List[ModelConfig]:
    """Width/depth ladder of one family: variant 0 costs ~``min_scale`` of
    the base, the last variant is the base configuration itself."""
    out = []
    scales = np.geomspace(min_scale, 1.0, n_variants)
    for i, s in enumerate(scales):
        w = max(int(round(base.d_model * np.sqrt(s) / 64)) * 64, 64)
        n_layers = max(int(round(base.num_layers * np.sqrt(s))), 2)
        heads = max(base.num_heads * w // base.d_model, 1)
        kv = max(min(base.num_kv_heads, heads), 1)
        out.append(
            dataclasses.replace(
                base,
                arch_id=f"{base.arch_id}-v{i}",
                num_layers=n_layers,
                d_model=w,
                num_heads=heads,
                num_kv_heads=kv,
                head_dim=w // heads,
                d_ff=max(base.d_ff * w // base.d_model, 64) if base.d_ff else 0,
            )
        )
    return out


@dataclasses.dataclass
class ModelZoo:
    services: List[ServiceSpec]

    @property
    def n_services(self) -> int:
        return len(self.services)

    @property
    def n_variants(self) -> int:
        return max(len(s.variants) for s in self.services)


def build_cluster_spec(
    zoo: ModelZoo,
    edge_classes: Sequence[str],           # hardware class per edge server
    cloud_classes: Sequence[str],          # hardware class per cloud server
    *,
    prompt_tokens: int = 128,
    gen_tokens: int = 32,
    edge_variants: int = 6,                # only the cheapest variants fit on edges
    edge_service_frac: float = 0.6,
    gamma_frame: Optional[np.ndarray] = None,
    eta_frame: Optional[np.ndarray] = None,
    seed: int = 0,
    measured_proc: Optional[Dict] = None,  # {(server, service, variant): ms}
) -> ClusterSpec:
    """The simulator's cluster description from the zoo.

    T^proc_{jkl} is the roofline latency of variant l of service k on server
    j's hardware class (or the measurement, when given): the paper's
    "processing delay based on our testbed results".  Placement on an edge
    draws from ``default_rng(seed)`` in the reference's order."""
    rng = np.random.default_rng(seed)
    hw: List[HardwareClass] = [HW_CLASSES[c] for c in edge_classes] + [
        HW_CLASSES[c] for c in cloud_classes
    ]
    M = len(hw)
    n_edge = len(edge_classes)
    K = zoo.n_services
    L = zoo.n_variants

    proc = np.full((M, K, L), 1e9, np.float32)
    placed = np.zeros((M, K, L), bool)
    acc = np.zeros((K, L), np.float32)

    for k, svc in enumerate(zoo.services):
        accs = svc.accuracies()
        for l, vcfg in enumerate(svc.variants):
            acc[k, l] = accs[l]
            for j in range(M):
                is_cloud = j >= n_edge
                on_server = is_cloud or (
                    l < edge_variants and rng.random() < edge_service_frac
                )
                if not on_server:
                    continue
                placed[j, k, l] = True
                key = (j, k, l)
                if measured_proc and key in measured_proc:
                    proc[j, k, l] = measured_proc[key]
                else:
                    proc[j, k, l] = request_latency_ms(vcfg, hw[j], prompt_tokens, gen_tokens)

    gamma = (
        gamma_frame
        if gamma_frame is not None
        else np.array([h.chips * 3000.0 for h in hw], np.float32)  # unit-ms per frame
    )
    eta = (
        eta_frame
        if eta_frame is not None
        else np.array([(6000.0 if j >= n_edge else 600.0) for j in range(M)], np.float32)
    )
    return ClusterSpec(
        n_edge=n_edge,
        n_cloud=M - n_edge,
        gamma_frame=np.asarray(gamma, np.float32),
        eta_frame=np.asarray(eta, np.float32),
        proc_ms=proc,
        placed=placed,
        acc=acc,
    )
