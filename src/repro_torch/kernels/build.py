"""Build and load the port's CUDA kernels: ``nvcc`` by hand, ``ctypes`` to bind.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface, built
for Hopper (``sm_90a``) into a shared library at first use and loaded with
``ctypes``.  No PyTorch header is included, so a build takes seconds.  The
library lands in ``_build/`` beside this module (listed in ``.gitignore``),
named by a hash of the source and the flags it is built with (``_flags``),
so an edited source or flag set is never served from a stale build.  Several sources build in parallel, one ``nvcc``
process each, all started together (:func:`build_libraries`).

Nothing here runs when the module is imported: the CPU tests import every
module of the port, and this machine need not have ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["NVCC_FLAGS", "ATTN_NVCC_FLAGS", "BuildInfo", "build_libraries", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: ``--fmad=false``: no multiply-add contraction anywhere in the library, on
#: top of the kernels' explicit round-to-nearest intrinsics (bit parity with
#: the reference's separately rounded products and sums).  ``-Xptxas -v``
#: records registers, shared memory and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: the model kernels (attention, SSD) need no bit parity (their plain
#: versions are held to a tolerance), so they are built without
#: ``--fmad=false``: their dot products contract into fused multiply-adds
ATTN_NVCC_FLAGS = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")

#: each source's flags; a source not listed takes ``NVCC_FLAGS``
_SOURCE_FLAGS = {
    "flash_attention": ATTN_NVCC_FLAGS,
    "flash_attention_wgmma": ATTN_NVCC_FLAGS,
    "decode_attention": ATTN_NVCC_FLAGS,
    "ssd_scan": ATTN_NVCC_FLAGS,
}


def _flags(name: str):
    return _SOURCE_FLAGS.get(name, NVCC_FLAGS)

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """One library: where it is, how long ``nvcc`` took (0.0 when it was
    already built), and the compiler's ``-Xptxas -v`` report."""

    name: str
    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_libraries(names: Iterable[str]) -> Dict[str, BuildInfo]:
    """Build every named kernel library that is not built yet, one ``nvcc``
    process per source, all started together; raise if any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    out: Dict[str, BuildInfo] = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        log_path = target.with_suffix(".log")
        if target.exists():
            log = log_path.read_text() if log_path.exists() else ""
            out[name] = BuildInfo(name, target, 0.0, log)
            continue
        nvcc = nvcc or _nvcc()
        # build to a private name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, target, log_path)
    failed = []
    for name, (proc, tmp, target, log_path) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        log_path.write_text(log)
        out[name] = BuildInfo(name, target, seconds, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            info = build_libraries([name])[name]
            lib = ctypes.CDLL(str(info.path))
            _LOADED[name] = lib
        return lib
