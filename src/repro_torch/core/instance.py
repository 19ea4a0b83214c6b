"""Problem-instance model for the MUS (Maximal User Satisfaction) problem.

PyTorch counterpart of ``repro.core.instance``, with the same layout: every
request asks for exactly one service ``k_i``, so each ``(i, j, l)`` tensor
has already been gathered at ``k = k_i`` and the scheduler works on
``(N, M, L)`` candidate grids.

The generators draw on the host with numpy ``Generator``s in exactly the
reference's order, so one seed gives the same instance in both packages;
:meth:`FlatInstance.from_numpy` then places the leaves on a device.  Entry
points that place data (``generate_instance``, ``generate_batch``) run on
the card unless the caller asks for the CPU: ``device=None`` means
``"cuda"``, and a missing CUDA device raises instead of falling back.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "FlatInstance",
    "GeneratorConfig",
    "generate_instance",
    "generate_batch",
    "stack_instances",
    "pad_instance",
    "resolve_device",
]

#: dtype of every instance leaf; the rest are float32
_LEAF_DTYPES = {"cover": torch.int32, "avail": torch.bool}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device is present — an entry point never silently runs on the CPU; the
    caller passes ``device="cpu"`` for that.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class FlatInstance:
    """One MUS problem instance (or a batch), flattened to (N, M, L) tensors.

    Shapes (unbatched; a batch adds a leading ``(B,)`` axis to every leaf):
      cover:  (N,)  int32   covering edge server s_i of request i
      A:      (N,)  f32     requested accuracy floor
      C:      (N,)  f32     requested deadline (ms)
      w_a:    (N,)  f32     accuracy weight in the US metric
      w_c:    (N,)  f32     latency weight in the US metric
      acc:    (N, M, L) f32 accuracy delivered by variant l of service k_i on j
      ctime:  (N, M, L) f32 completion time
      v:      (N, M, L) f32 computation cost charged against gamma_j
      u:      (N, M, L) f32 communication cost charged against eta_{s_i}
      avail:  (N, M, L) bool service k_i / variant l placed on server j
      gamma:  (M,)  f32     computation capacity per server
      eta:    (M,)  f32     communication capacity per server
      max_as: ()    f32     normalizer: max accuracy in the system
      max_cs: ()    f32     normalizer: worst-case completion time
    """

    cover: torch.Tensor
    A: torch.Tensor
    C: torch.Tensor
    w_a: torch.Tensor
    w_c: torch.Tensor
    acc: torch.Tensor
    ctime: torch.Tensor
    v: torch.Tensor
    u: torch.Tensor
    avail: torch.Tensor
    gamma: torch.Tensor
    eta: torch.Tensor
    max_as: torch.Tensor
    max_cs: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.acc.device

    def to(self, device, non_blocking: bool = False) -> "FlatInstance":
        """The same instance with every leaf on ``device``."""
        return FlatInstance(
            **{
                f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
                for f in dataclasses.fields(self)
            }
        )

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], device) -> "FlatInstance":
        """Build an instance from numpy leaves, e.g. the reference's
        ``{k: np.asarray(getattr(inst, k))}`` or a golden ``.npz`` file.

        Extra keys are ignored, so a fixture's expected outputs can ride
        along in the mapping.  ``device`` is explicit: pass ``"cpu"`` or
        ``"cuda"``.
        """
        out = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(arrays[f.name])
            if not (a.flags.c_contiguous and a.flags.writeable):
                a = a.copy()  # broadcast views: no zero strides, no read-only buffers
            dtype = _LEAF_DTYPES.get(f.name, torch.float32)
            out[f.name] = torch.from_numpy(a).to(device=device, dtype=dtype)
        return cls(**out)

    def numpy(self) -> dict:
        """The leaves as numpy arrays (the inverse of :meth:`from_numpy`)."""
        return {
            f.name: getattr(self, f.name).cpu().numpy()
            for f in dataclasses.fields(self)
        }


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Defaults reproduce the paper's numerical setup (Sec. IV).

    9 heterogeneous edge servers + 1 cloud; |N|=100 requests, |K|=100 services,
    |L|=10 variants; edge T_proc ~ U[950, 1300] ms, cloud 300 ms;
    A_i ~ N(45, 10) [%], C_i ~ N(1000, 4000) ms; T^q ~ U[0, 50] ms;
    Max_as = 100 %, Max_cs = 12000 ms; mean bandwidth 600 bytes/ms.
    """

    n_requests: int = 100
    n_edge: int = 9
    n_cloud: int = 1
    n_services: int = 100
    n_variants: int = 10

    acc_req_mean: float = 45.0
    acc_req_std: float = 10.0
    delay_req_mean: float = 1000.0
    delay_req_std: float = 4000.0
    queue_delay_max: float = 50.0
    w_a: float = 1.0
    w_c: float = 1.0

    max_as: float = 100.0
    max_cs: float = 12000.0

    proc_edge_lo: float = 950.0
    proc_edge_hi: float = 1300.0
    proc_cloud: float = 300.0

    acc_top: float = 92.0
    acc_bottom: float = 35.0

    bandwidth: float = 600.0
    req_size_lo: float = 20_000.0
    req_size_hi: float = 120_000.0
    cloud_extra_delay: float = 100.0

    edge_compute_classes: tuple = (2600.0, 3900.0, 5200.0)
    edge_comm_classes: tuple = (400.0, 600.0, 800.0)
    cloud_compute: float = 26_000.0
    cloud_comm: float = 6000.0

    edge_services_frac: tuple = (0.25, 0.5, 0.75)
    edge_variants: int = 6


def _variant_ladder(cfg: GeneratorConfig, rng: np.random.Generator):
    """Per-(service, variant) accuracy and relative cost."""
    L, K = cfg.n_variants, cfg.n_services
    rel_cost = np.geomspace(0.12, 1.0, L)
    base = cfg.acc_bottom + (cfg.acc_top - cfg.acc_bottom) * (
        1.0 - np.exp(-3.0 * rel_cost)
    ) / (1.0 - np.exp(-3.0))
    acc = base[None, :] + rng.normal(0.0, 2.0, size=(K, L))
    acc = np.clip(np.sort(acc, axis=1), 1.0, cfg.max_as)
    return acc.astype(np.float32), rel_cost.astype(np.float32)


def _instance_arrays(seed: int, cfg: GeneratorConfig) -> dict:
    """One instance's numpy leaves, drawn in the reference's exact order."""
    rng = np.random.default_rng(seed)
    N = cfg.n_requests
    M = cfg.n_edge + cfg.n_cloud
    K, L = cfg.n_services, cfg.n_variants
    is_cloud = np.arange(M) >= cfg.n_edge

    edge_class = rng.integers(0, len(cfg.edge_compute_classes), size=cfg.n_edge)
    gamma = np.empty(M, np.float32)
    eta = np.empty(M, np.float32)
    svc_frac = np.empty(M, np.float32)
    for j in range(M):
        if is_cloud[j]:
            gamma[j] = cfg.cloud_compute
            eta[j] = cfg.cloud_comm
            svc_frac[j] = 1.0
        else:
            c = edge_class[j]
            gamma[j] = cfg.edge_compute_classes[c]
            eta[j] = cfg.edge_comm_classes[c]
            svc_frac[j] = cfg.edge_services_frac[c]

    acc_kl, rel_cost = _variant_ladder(cfg, rng)

    placed = np.zeros((M, K, L), bool)
    for j in range(M):
        if is_cloud[j]:
            placed[j] = True
        else:
            ks = rng.random(K) < svc_frac[j]
            placed[j, ks, : cfg.edge_variants] = True

    proc = np.empty((M, K, L), np.float32)
    for j in range(M):
        base = (
            cfg.proc_cloud
            if is_cloud[j]
            else rng.uniform(cfg.proc_edge_lo, cfg.proc_edge_hi)
        )
        proc[j] = base * rel_cost[None, :] * rng.uniform(0.95, 1.05, size=(K, L))

    service = rng.integers(0, K, size=N)
    cover = rng.integers(0, cfg.n_edge, size=N)
    A = np.clip(rng.normal(cfg.acc_req_mean, cfg.acc_req_std, N), 1.0, 99.0)
    C = np.clip(rng.normal(cfg.delay_req_mean, cfg.delay_req_std, N), 50.0, None)
    Tq = rng.uniform(0.0, cfg.queue_delay_max, N)
    size = rng.uniform(cfg.req_size_lo, cfg.req_size_hi, N)

    comm_delay = size[:, None] / cfg.bandwidth + np.where(
        is_cloud[None, :], cfg.cloud_extra_delay, 0.0
    )
    local = cover[:, None] == np.arange(M)[None, :]
    comm_delay = np.where(local, 0.0, comm_delay)

    acc_nml = np.broadcast_to(acc_kl[service][:, None, :], (N, M, L))
    proc_nml = proc[:, service, :].transpose(1, 0, 2)
    ctime = Tq[:, None, None] + proc_nml + comm_delay[:, :, None]
    avail = placed[:, service, :].transpose(1, 0, 2)
    u = np.where(local[:, :, None], 0.0, (size / 1024.0)[:, None, None])

    return dict(
        cover=cover.astype(np.int32),
        A=A.astype(np.float32),
        C=C.astype(np.float32),
        w_a=np.full(N, cfg.w_a, np.float32),
        w_c=np.full(N, cfg.w_c, np.float32),
        acc=acc_nml.astype(np.float32),
        ctime=ctime.astype(np.float32),
        v=proc_nml.astype(np.float32),
        u=np.broadcast_to(u, (N, M, L)).astype(np.float32),
        avail=np.ascontiguousarray(avail),
        gamma=gamma,
        eta=eta,
        max_as=np.float32(cfg.max_as),
        max_cs=np.float32(cfg.max_cs),
    )


def generate_instance(
    seed: int, cfg: Optional[GeneratorConfig] = None, *, as_numpy: bool = False, device=None
) -> FlatInstance:
    """Draw one MUS instance per the paper's numerical setup, on ``device``;
    with ``as_numpy``, an instance of numpy leaves on the host, as the
    reference's (``device`` is then not read)."""
    arrays = _instance_arrays(seed, cfg or GeneratorConfig())
    if as_numpy:
        return FlatInstance(**arrays)
    return FlatInstance.from_numpy(arrays, resolve_device(device))


def generate_batch(
    seed: int, n: int, cfg: Optional[GeneratorConfig] = None, *, device=None
) -> FlatInstance:
    """``n`` instances (seeds ``seed .. seed+n-1``) stacked on a leading axis.

    Drawn on the host and copied to ``device`` once per leaf.
    """
    dev = resolve_device(device)
    cfg = cfg or GeneratorConfig()
    parts = [_instance_arrays(seed + i, cfg) for i in range(n)]
    return FlatInstance.from_numpy(
        {k: np.stack([p[k] for p in parts]) for k in parts[0]}, dev
    )


def pad_instance(inst: FlatInstance, n_pad: int) -> FlatInstance:
    """Pad the request axis of an (unbatched) instance to ``n_pad`` rows.

    Padded rows are *infeasible everywhere* (``avail`` False, ``A=1e9``,
    ``C=-1``) and *free* (zero v/u and zero US weights), and they sit at
    the end — so every scheduler that honours feasibility drops them
    (j = l = -1) without touching any capacity, and the first ``N``
    assignments equal those of the unpadded instance.  Server-axis leaves
    and the scalars pass through untouched.
    """
    N = inst.A.shape[-1]
    if n_pad == N:
        return inst
    if n_pad < N:
        raise ValueError(f"cannot pad {N} requests down to {n_pad}")
    p = n_pad - N

    def _pad(x, fill):
        return torch.cat([x, torch.full((p,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)])

    return dataclasses.replace(
        inst,
        cover=_pad(inst.cover, 0),
        A=_pad(inst.A, 1e9),
        C=_pad(inst.C, -1.0),
        w_a=_pad(inst.w_a, 0.0),
        w_c=_pad(inst.w_c, 0.0),
        acc=_pad(inst.acc, 0.0),
        ctime=_pad(inst.ctime, 1e9),
        v=_pad(inst.v, 0.0),
        u=_pad(inst.u, 0.0),
        avail=_pad(inst.avail, False),
    )


def stack_instances(insts: Sequence[FlatInstance]) -> FlatInstance:
    """Stack same-shape instances on a new leading batch axis."""
    return FlatInstance(
        **{
            f.name: torch.stack([getattr(x, f.name) for x in insts])
            for f in dataclasses.fields(FlatInstance)
        }
    )
