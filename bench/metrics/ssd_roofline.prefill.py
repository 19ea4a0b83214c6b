"""``ssd_scan``'s share of its roofline over the traced window, in %: least
times summed over the device time of every kernel named ``ssd_scan`` (both
routes).  A prefill launch over B prompts of S tokens reads x (B S H P),
dt (B S H) and B, C (B S G N) in bf16 and A (H) in f32 once, writes y (B S
H P) in bf16 and the final state (B H N P) in f32 once; its FLOPs are the
chunked products of ``_model.ssd_flops`` (C B^T on its causal half).  Each
prefill launches it once per block of the family's ``ssd_blocks``."""
from bench.harness.manifest import family
from bench.harness.peaks import least_seconds
from bench.metrics._model import ssd_flops

KERNEL = "ssd_scan"


def launch(c: dict, B: int, S: int):
    """(bytes, FLOPs) of one launch."""
    di = c["ssm_expand"] * c["d_model"]
    P, G, N = c["ssm_headdim"], c["ssm_ngroups"], c["ssm_state"]
    H = di // P
    nbytes = (2 * B * S * H * P * 2 + B * S * H * 2 + H * 4 + 2 * B * S * G * N * 2
              + B * H * N * P * 4)
    return nbytes, B * ssd_flops(c, S)


def read(run):
    if run.trace is None:
        return None
    blocks = family(run.cfg).model.ssd_blocks(run.cfg)
    spent = sum(d for _, _, d in run.trace.kernels(KERNEL))
    if not blocks or spent <= 0:
        return None
    least = sum(blocks * least_seconds(*launch(run.cfg, b.batch, b.length))
                for b in run.batches)
    return 100.0 * least / spent
