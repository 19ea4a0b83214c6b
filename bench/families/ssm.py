"""``ssm``: pre-norm Mamba-2 blocks and no attention (mamba2-130m;
arXiv:2405.21060)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

from bench.harness.weights import Leaf, proj

WIDTHS = ("num_layers", "d_model", "vocab_size", "ssm_state", "ssm_headdim", "ssm_expand",
          "ssm_ngroups", "ssm_conv", "ssd_chunk")


def dims(c: dict) -> Tuple[int, int, int, int]:
    """(d_inner, heads, groups, state) of a Mamba-2 block."""
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_headdim"], c["ssm_ngroups"], c["ssm_state"]


def block(c: dict) -> Dict[str, Any]:
    """One Mamba-2 block's leaves (its pre-norm ``ln`` and the mixer)."""
    d = c["d_model"]
    di, H, G, N = dims(c)
    GN = G * N
    return {
        "ln": {"scale": Leaf((d,), "ones")},
        "mamba": {
            "in_proj": proj(d, d, 2 * di + 2 * GN + H),
            "conv_w": Leaf((c["ssm_conv"], di + 2 * GN), "normal", 0.2),
            "conv_b": Leaf((di + 2 * GN,), "zeros"),
            "A_log": Leaf((H,), "a_log"),
            "dt_bias": Leaf((H,), "dt_bias"),
            "D": Leaf((H,), "ones"),
            "norm_scale": Leaf((di,), "ones"),
            "out_proj": proj(di, di, d),
        },
    }


def block_weights(c: dict) -> int:
    """Weights of one block's input and output projections."""
    di, H, G, N = dims(c)
    return c["d_model"] * (2 * di + 2 * G * N + H) + di * c["d_model"]


def layout(c: dict) -> Dict[str, Any]:
    return {"layers": [block(c) for _ in range(c["num_layers"])]}


def matmul_weights(c: dict) -> int:
    return c["num_layers"] * block_weights(c)


def attention(c: dict) -> Tuple[int, int, int, int]:
    return 0, 0, 0, 0


def ssd_blocks(c: dict) -> int:
    return c["num_layers"]
