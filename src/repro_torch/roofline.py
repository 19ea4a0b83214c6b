"""Roofline analysis of the dry-run's sharded steps, on the H100's numbers.

The port's counterpart of ``repro/roofline.py``.  Per (arch x shape x
mesh) three terms bound one device's step:

  compute    = FLOPs_per_device / peak FLOP/s         (989 TFLOP/s bf16)
  memory     = bytes_per_device / HBM rate            (3.35 TB/s)
  collective = collective_bytes_per_device / link rate (450 GB/s, NVLink 4
               one way)

The reference reads these from XLA's compiled artifact (``cost_analysis``
and the HLO text).  The port runs eagerly, so it counts them while the step
runs, on one rank of a ``fake`` process group under ``FakeTensorMode``
(``launch/dryrun.py``), with :class:`DeviceCounter`: a dispatch mode that
sees the *local* ops each DTensor op runs on rank 0's shards (a count taken
above DTensor would be of the global op) and

* counts their FLOPs with ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention; elementwise work counts none there);
* counts the bytes each op that is not a view reads and writes, every
  tensor input and output once: an eager program's memory traffic, where
  XLA's ``bytes accessed`` is that of its fused program;
* sums the output bytes of every collective by kind (output size ~= wire
  traffic per device; a ring all-reduce moves ~2x, a method note, not the
  numbers), and keeps the collective counts of
  ``torch.distributed.tensor.debug.CommDebugMode``, which it wraps.

MODEL_FLOPS = 6 N_active D (train) or 2 N_active D (inference), and the
useful-compute ratio MODEL_FLOPS / FLOPs catches recomputation (remat).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HWSpec", "H100", "DeviceCounter", "collective_bytes", "roofline_terms",
           "RooflineReport"]


@dataclasses.dataclass(frozen=True)
class HWSpec:
    """One device's peak rates.  The defaults are the H100 SXM data sheet's
    (dense, no sparsity), which assume the card's full 700 W power limit;
    a card set below it runs slower under load."""

    name: str = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
    peak_flops: float = 989e12    # bf16 / fp16 tensor cores, dense
    hbm_bw: float = 3.35e12       # bytes/s
    link_bw: float = 450e9        # bytes/s, NVLink 4 to the other cards, one way


H100 = HWSpec()

#: the reference's collective kinds (HLO names), and the PyTorch
#: functional-collective ops each covers
_COLLECTIVES = {
    "all-gather": ("all_gather",),
    "all-reduce": ("all_reduce",),
    "reduce-scatter": ("reduce_scatter",),
    "all-to-all": ("all_to_all",),
    "collective-permute": ("permute", "send", "recv"),
}


def _kind(op_name: str) -> Optional[str]:
    """The collective kind of an op's name, or ``None``."""
    if "c10d" not in op_name and "_dtensor" not in op_name:
        return None
    for kind, names in _COLLECTIVES.items():
        if any(n in op_name for n in names):
            return kind
    return None


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_flatten

    return sum(t.numel() * t.element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's local work while a sharded step runs (module
    docstring): ``flops``, ``bytes``, ``coll`` (bytes by kind) and, from
    the wrapped ``CommDebugMode``, ``comm_counts``.  Enter it inside
    ``FakeTensorMode`` (or on real tensors) around the step only."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor.debug import CommDebugMode

        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
        self.comm = CommDebugMode()
        self._inner = 0   # > 0 while DTensor infers an output's shape on the global tensors
        self._patched = []

    # DTensor runs each new op once on fake global tensors to learn its
    # output's shape; that is no device's work, so it is not counted.  The
    # methods are private to DTensor: where none of them exists the counts
    # would take in the global ops, so the counter refuses to start
    def _wrap_propagator(self):
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        if not any(hasattr(prop, name) for name in _PROPAGATOR_METHODS):
            raise RuntimeError(
                f"DeviceCounter: this torch ({torch.__version__}) has none of DTensor's "
                f"shape-inference methods {_PROPAGATOR_METHODS}; without them the counts "
                "would include the global ops DTensor runs to infer shapes"
            )
        for name in _PROPAGATOR_METHODS:
            orig = getattr(prop, name, None)
            if orig is None:
                continue

            def wrapped(*a, _orig=orig, **k):
                self._inner += 1
                try:
                    return _orig(*a, **k)
                finally:
                    self._inner -= 1

            self._patched.append((prop, name, vars(prop).get(name)))
            setattr(prop, name, wrapped)

    def __enter__(self):
        self._wrap_propagator()
        self.comm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.comm.__exit__(*exc)
            for prop, name, own in reversed(self._patched):
                if own is None:
                    delattr(prop, name)  # the class's method shows again
                else:
                    setattr(prop, name, own)
            self._patched.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(isinstance(a, DTensor) for a in tree_flatten((args, kwargs))[0]):
            return NotImplemented  # DTensor runs it on the local shards, which come back here
        out = func(*args, **kwargs)
        if self._inner:
            return out
        kind = _kind(str(func))
        if kind is not None:
            self.coll[kind] += _nbytes(out)
            return out
        if not func.is_view and func._overloadpacket not in _NO_TRAFFIC:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        return out

    def counts(self) -> Dict[str, float]:
        """``(flops, bytes, coll, coll_breakdown, comm_counts)`` of the run."""
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "coll": float(sum(self.coll.values())),
            "coll_breakdown": dict(self.coll),
            "comm_counts": {str(k): int(v) for k, v in self.comm.get_comm_counts().items()},
        }


#: the sharding propagator's methods that run an op on fake global tensors
#: to infer its output's shape (torch 2.4 and later: at least one of them)
_PROPAGATOR_METHODS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")

_aten = torch.ops.aten
#: ops that only allocate or alias a tensor, moving no data
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
               _aten.detach, _aten.lift_fresh}


def collective_bytes(counter: DeviceCounter) -> Dict[str, int]:
    """Per-collective-kind output bytes of one rank's run (the reference
    parses them from HLO text)."""
    return {k: int(v) for k, v in counter.coll.items()}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_per_device: float
    useful_ratio: float
    memory_analysis: Optional[str] = None
    # kept for the reference's report format, and the one place they are
    # described: the reference corrects XLA:CPU's once-counted scan bodies
    # (``roofline_terms(corrected_counts=)``, ``dryrun --no-loop-correct``);
    # an eager run counts every layer, so the dry-run never corrects,
    # ``loop_corrected`` is False and the raw counts equal the table's
    loop_corrected: bool = False
    raw_flops_per_device: Optional[float] = None
    raw_bytes_per_device: Optional[float] = None
    raw_coll_bytes_per_device: Optional[float] = None
    #: the spec the three terms divide by, and the collective counts
    hw: Optional[str] = None
    comm_counts: Optional[Dict[str, int]] = None

    def as_dict(self):
        return dataclasses.asdict(self)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, default=str)

    @staticmethod
    def load(path: str) -> "RooflineReport":
        with open(path) as f:
            return RooflineReport(**json.load(f))

    def row(self) -> str:
        return (
            f"{self.arch:22s} {self.shape:12s} {self.mesh:10s} "
            f"comp={self.compute_s*1e3:9.3f}ms mem={self.memory_s*1e3:9.3f}ms "
            f"coll={self.collective_s*1e3:9.3f}ms -> {self.bottleneck:10s} "
            f"useful={self.useful_ratio:6.1%}"
        )


def roofline_terms(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_devices: int,
    counts: Dict[str, float],
    model_flops_total: float,
    hw: HWSpec = H100,
    memory_analysis: Optional[str] = None,
    corrected_counts: Optional[Dict[str, float]] = None,
) -> RooflineReport:
    """The three terms and the bottleneck from one rank's ``counts``
    (:meth:`DeviceCounter.counts`: ``flops``, ``bytes``, ``coll``,
    ``coll_breakdown``); ``corrected_counts``, where given, take their
    place in the table (the raw ones stay beside them)."""
    use = corrected_counts or counts
    flops = use["flops"]
    bytes_accessed = use["bytes"]
    coll = use.get("coll_breakdown", counts.get("coll_breakdown", {}))
    coll_total = use["coll"]

    compute_s = flops / hw.peak_flops
    memory_s = bytes_accessed / hw.hbm_bw
    collective_s = coll_total / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)

    model_pd = model_flops_total / n_devices
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_devices=n_devices,
        flops_per_device=flops,
        bytes_per_device=bytes_accessed,
        coll_bytes_per_device=coll_total,
        coll_breakdown={k: int(v) for k, v in coll.items()},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_per_device=model_pd,
        useful_ratio=(model_pd / flops) if flops else 0.0,
        memory_analysis=memory_analysis,
        loop_corrected=corrected_counts is not None,
        raw_flops_per_device=counts["flops"],
        raw_bytes_per_device=counts["bytes"],
        raw_coll_bytes_per_device=counts["coll"],
        hw=hw.name,
        comm_counts=counts.get("comm_counts"),
    )
