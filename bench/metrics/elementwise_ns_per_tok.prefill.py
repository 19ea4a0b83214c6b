"""Device time of everything but the matrix products and the hand-written
kernels (norms, RoPE, residuals, activations, casts, the Mamba-2 block's
conv and gates, cache writes), in ns a prompt token of the traced window.
cuBLAS kernels are known by their names."""

#: substrings of the library's matrix-product kernels (lower case)
MATMUL = ("gemm", "nvjet", "xmma", "cutlass", "splitkreduce", "cublas")
#: the program's hand-written model kernels
HAND = ("flash_attention", "decode_attention", "ssd_scan")


def kind(name: str) -> str:
    """``matmul``, a hand kernel's name, ``copy`` or ``elementwise``."""
    if any(m in name.lower() for m in MATMUL):
        return "matmul"
    for h in HAND:
        if h in name:
            return h
    return "copy" if name.startswith(("Memcpy", "Memset")) else "elementwise"


def read(run):
    tokens = sum(b.batch * b.length for b in run.batches)
    if run.trace is None or not tokens:
        return None
    seconds = sum(d for n, _, d in run.trace.ops if kind(n) == "elementwise")
    return seconds * 1e9 / tokens if seconds > 0 else None
