"""``zamba2``: Zamba2's Mamba-2 layers with shared transformer blocks at the
hybrid layers (Zamba2-7B; arXiv:2411.15242).  The family's own settings
are read under their published names: ``hybrid_layer_ids``,
``num_mem_blocks``, ``adapter_rank``."""
from __future__ import annotations

from typing import Any, Dict, Tuple

from bench.harness.weights import Leaf, proj

from . import ssm

WIDTHS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
          "vocab_size", "ssm_state", "ssm_headdim", "ssm_expand", "ssm_ngroups", "ssm_conv",
          "ssd_chunk", "hybrid_layer_ids", "num_mem_blocks", "adapter_rank")


def shared_block(c: dict) -> Dict[str, Any]:
    """One shared block's leaves: q, k and v at fan-in 2 d_model (the
    concatenation they read), the MLP's gate and up apart."""
    d, H, KV, hd, f = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_ff"]
    din = 2 * d
    return {
        "ln1": {"scale": Leaf((din,), "ones")},
        "attn": {"w_q": proj(din, din, H, hd), "w_k": proj(din, din, KV, hd),
                 "w_v": proj(din, din, KV, hd), "w_o": proj(H * hd, H, hd, d)},
        "ln2": {"scale": Leaf((d,), "ones")},
        "mlp": {"w_up": proj(d, d, f), "w_down": proj(f, f, d), "w_gate": proj(d, d, f)},
    }


def site(c: dict) -> Dict[str, Any]:
    """One site's own leaves: the adapter on the gate/up product and the
    linear into its layer's Mamba-2 input."""
    d, r, f = c["d_model"], c["adapter_rank"], c["d_ff"]
    return {"lora_a": proj(d, d, r), "lora_b": proj(r, r, 2 * f), "linear": proj(d, d, d)}


def layout(c: dict) -> Dict[str, Any]:
    return {"layers": [ssm.block(c) for _ in range(c["num_layers"])],
            "shared_blocks": [shared_block(c) for _ in range(c["num_mem_blocks"])],
            "sites": [site(c) for _ in c["hybrid_layer_ids"]]}


def site_weights(c: dict) -> int:
    """Weights of the products of one site's application: its shared
    block's, its adapter's and its linear's."""
    d, H, KV, hd, f = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_ff"]
    r = c["adapter_rank"]
    return (2 * d * (H + 2 * KV) * hd + H * hd * d + 3 * d * f
            + d * r + r * 2 * f + d * d)


def matmul_weights(c: dict) -> int:
    """The Mamba-2 layers' products, and each site's as it fires."""
    return c["num_layers"] * ssm.block_weights(c) + len(c["hybrid_layer_ids"]) * site_weights(c)


def attention(c: dict) -> Tuple[int, int, int, int]:
    return len(c["hybrid_layer_ids"]), c["num_heads"], c["num_kv_heads"], c["head_dim"]


def ssd_blocks(c: dict) -> int:
    return c["num_layers"]
