"""``dense``: a pre-norm decoder, each layer grouped-query attention and then
the gated MLP (yi-9b)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

from bench.harness.weights import Leaf, proj

WIDTHS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
          "vocab_size")


def block(c: dict) -> Dict[str, Any]:
    """One layer's leaves: q, k and v at fan-in d_model."""
    d, H, KV, hd, f = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_ff"]
    return {
        "ln1": {"scale": Leaf((d,), "ones")},
        "attn": {"w_q": proj(d, d, H, hd), "w_k": proj(d, d, KV, hd),
                 "w_v": proj(d, d, KV, hd), "w_o": proj(H * hd, H, hd, d)},
        "ln2": {"scale": Leaf((d,), "ones")},
        "mlp": {"w_up": proj(d, d, f), "w_down": proj(f, f, d), "w_gate": proj(d, d, f)},
    }


def block_weights(c: dict) -> int:
    """Weights of one layer's products."""
    d, H, KV, hd, f = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_ff"]
    return d * (H + 2 * KV) * hd + H * hd * d + 3 * d * f


def layout(c: dict) -> Dict[str, Any]:
    return {"layers": [block(c) for _ in range(c["num_layers"])]}


def matmul_weights(c: dict) -> int:
    return c["num_layers"] * block_weights(c)


def attention(c: dict) -> Tuple[int, int, int, int]:
    return c["num_layers"], c["num_heads"], c["num_kv_heads"], c["head_dim"]


def ssd_blocks(c: dict) -> int:
    return 0
