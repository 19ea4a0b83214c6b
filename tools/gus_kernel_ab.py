#!/usr/bin/env python3
"""Time the port's GUS kernel beside another build of its C interface, on one GPU.

    python3 tools/gus_kernel_ab.py --baseline path/to/gus_assign.cu

``--baseline`` is a CUDA source exporting the same ``gus_assign_launch`` as
``src/repro_torch/kernels/csrc/gus_assign.cu`` (an earlier version of it,
for instance, written out with ``git show <commit>:<path>``).  Both are built
with the port's nvcc flags.  At each shape both are held against the plain
version ``gus_assign_ref`` bit for bit, then timed in turns (baseline,
kernel, kernel, baseline): by CUDA events around ``--reps`` eager calls
after two warm-up calls, and as device time, one replay of a captured CUDA
graph of ``--reps`` calls, which leaves out the wrappers' host time.  The
shapes are those of ``chip_smoke.py`` phase 10: the dense fleet's first frame of replication 0
(B=1), its frame step (B=1024) and window (B=5120) at N=256, M=L=10, the
window with every budget spent (the chain's floor), and the paper batch
(B=20000, N=100).  The card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def build_baseline(src: Path, out_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    out = out_dir / "libgus_baseline.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  baseline ptxas: {line.strip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"baseline build failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.gus_assign_launch.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.gus_assign_launch.restype = ctypes.c_int
    return lib


def baseline_call(lib, args):
    """The baseline kernel on ``args`` (``gus_assign``'s arguments), with the
    outputs allocated as the wrapper allocates them."""
    import torch

    B, N, M, L = args[5].shape
    dev = args[5].device
    out_j = torch.empty((B, N), dtype=torch.int32, device=dev)
    out_l = torch.empty_like(out_j)
    w = torch.zeros((B, M), dtype=torch.float32, device=dev)
    c = torch.zeros_like(w)
    ptrs = [a.view(torch.uint8).data_ptr() if a.dtype == torch.bool else a.data_ptr()
            for a in args]
    err = lib.gus_assign_launch(*ptrs, out_j.data_ptr(), out_l.data_ptr(), w.data_ptr(),
                                c.data_ptr(), B, N, M, L,
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline launch failed: CUDA error {err}")
    return out_j, out_l, w, c


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gus_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=10)
    opt = ap.parse_args()

    import dataclasses

    from chip_smoke import dense_fleet_window, time_events, time_graph
    from repro_torch.core import FlatInstance, generate_batch
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.gus import gus_assign, gus_assign_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    info = build_libraries(["gus_assign"])["gus_assign"]
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  kernel ptxas: {line.strip()}")
    tmp = tempfile.TemporaryDirectory()
    base = build_baseline(opt.baseline, Path(tmp.name))

    dev = torch.device("cuda")
    fields = [f.name for f in dataclasses.fields(FlatInstance)]

    def args_of(batch, spent=False):
        B = batch.A.shape[0]
        out = [getattr(batch, f).expand(B).contiguous() if f in ("max_as", "max_cs")
               else getattr(batch, f).contiguous() for f in fields]
        if spent:
            out[10], out[11] = torch.zeros_like(out[10]), torch.zeros_like(out[11])
        return tuple(out)

    _, _, win = dense_fleet_window(dev, 1024, 5)
    first = lambda n: FlatInstance(**{f: getattr(win, f)[:n] for f in fields})  # noqa: E731
    shapes = [
        ("fleet first frame B=1 N=256 M=10 L=10", args_of(first(1))),
        ("fleet frame step B=1024 N=256 M=10 L=10", args_of(first(1024))),
        ("fleet window B=5120 N=256 M=10 L=10", args_of(win)),
        ("chain floor: fleet window, every budget spent", args_of(win, spent=True)),
        ("paper batch B=20000 N=100 M=10 L=10", args_of(generate_batch(0, 20000, device=dev))),
    ]
    for label, args in shapes:
        want = gus_assign_ref(*args)
        for name, got in (("kernel", gus_assign(*args)), ("baseline", baseline_call(base, args))):
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"{label}: {name} == plain: {same}")
            if not same:
                return 1
        calls = {"kernel": lambda: gus_assign(*args), "baseline": lambda: baseline_call(base, args)}
        for timer, how in ((time_events, "eager"), (time_graph, "device")):
            t = {"baseline": [], "kernel": []}
            for name in ("baseline", "kernel", "kernel", "baseline"):
                t[name].append(timer(calls[name], opt.reps))
            print(f"time {label} ({how}): kernel {t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} ms, "
                  f"baseline {t['baseline'][0]:.4f} / {t['baseline'][1]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
