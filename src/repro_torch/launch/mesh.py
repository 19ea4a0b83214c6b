"""Device layouts: the fleet's replication axis and the model meshes.

The port's counterpart of ``repro/launch/mesh.py``.  Functions, not
module-level constants, so that importing touches no device state and no
process group.

* :func:`make_fleet_mesh` is the 1-D ``("rep",)`` layout of
  ``simulate_fleet``: a list of ``torch.device("cuda", i)``.
* :func:`make_test_mesh` and :func:`make_production_mesh` build a
  ``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
  names and shapes over the current process group, which the caller
  starts (``torch.distributed.init_process_group``) with one rank a
  device: NCCL on the cards, ``gloo`` for the CPU tests, the ``fake``
  backend for the dry-run (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

__all__ = ["make_production_mesh", "make_test_mesh", "make_fleet_mesh", "mesh_name"]


def _device_type(device_type: Optional[str]) -> str:
    """The mesh's device type: as given, else ``"cuda"`` where a card is
    visible and ``"cpu"`` otherwise."""
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The reference's production layout: ``("data", "model")`` 16 x 16
    (256 devices), or ``("pod", "data", "model")`` 2 x 16 x 16 (512).

    ``pod`` is pure data parallelism, ``data`` the batch, ``model`` the
    tensor and expert axis.  Needs a process group of that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1, *, device_type: Optional[str] = None):
    """A small ``("data", "model")`` mesh over a process group of
    ``data * model`` ranks."""
    return _make_mesh((data, model), ("data", "model"), device_type)


def make_fleet_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first ``n_devices`` CUDA devices of the process (all of them by
    default), the ``("rep",)`` axis ``simulate_fleet`` spreads its
    replications over.  More than ``torch.cuda.device_count()`` raises,
    never a fallback to fewer (the reference raises above
    ``jax.local_device_count()``)."""
    avail = torch.cuda.device_count()
    n = avail if n_devices is None else int(n_devices)
    if n < 1 or n > avail:
        raise ValueError(
            f"make_fleet_mesh(n_devices={n_devices}): need 1 <= n_devices <= "
            f"torch.cuda.device_count() == {avail}"
        )
    return [torch.device("cuda", i) for i in range(n)]


def mesh_name(mesh: Union[Sequence[torch.device], "object"]) -> str:
    """``"16x16"`` for a ``DeviceMesh`` of that shape, ``"4"`` for a fleet
    layout of four devices."""
    if isinstance(mesh, (list, tuple)):
        return str(len(mesh))
    return "x".join(str(s) for s in mesh.shape)
