"""``flash_attention``'s share of its roofline over the traced window, in %:
the launches' least times summed, over the device time of every kernel
named ``flash_attention`` (both routes).  A launch over B prompts of S
tokens reads q, k, v and writes the output once, bf16 (2 B (H + KV) S hd
x 2 bytes), and does 4 hd FLOPs for each of the H S (S + 1) / 2 causal
(query, key) pairs of each prompt; its least time is the larger of its
bytes over the HBM rate and its FLOPs over the bf16 peak.  Each prefill
launches it once per attention site, at the shape of the family's
``attention``."""
from bench.harness.manifest import family
from bench.harness.peaks import least_seconds

KERNEL = "flash_attention"


def launch(c: dict, B: int, S: int):
    """(bytes, FLOPs) of one launch."""
    _, H, KV, hd = family(c).model.attention(c)
    return 2 * B * (H + KV) * S * hd * 2, 4 * hd * B * H * (S * (S + 1) // 2)


def read(run):
    if run.trace is None:
        return None
    spent = sum(d for _, _, d in run.trace.kernels(KERNEL))
    if spent <= 0:
        return None
    sites = family(run.cfg).model.attention(run.cfg)[0]
    least = sum(sites * least_seconds(*launch(run.cfg, b.batch, b.length))
                for b in run.batches)
    return 100.0 * least / spent
