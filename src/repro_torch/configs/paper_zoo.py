"""Paper-analog model zoo variants for the testbed example.

The paper's testbed serves two CNNs: SqueezeNet (edge, cheap, lower accuracy)
and GoogleNet (cloud, costly, higher accuracy).  Our analog is a ladder of
tiny decoder LMs of increasing size — they actually train/serve on CPU in
``examples/serve_edge.py``, and their measured eval accuracy/latency feed the
GUS scheduler the way the paper's testbed measurements do."""
from .base import ModelConfig

SQUEEZE_LM = ModelConfig(       # edge variant (SqueezeNet analog)
    arch_id="squeeze-lm",
    family="dense",
    source="paper-analog: SqueezeNet (arXiv:1602.07360)",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    scan_layers=False,
)

MID_LM = ModelConfig(           # intermediate edge variant
    arch_id="mid-lm",
    family="dense",
    source="paper-analog: intermediate variant",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=1024,
    vocab_size=512,
    scan_layers=False,
)

GOOGLE_LM = ModelConfig(        # cloud variant (GoogleNet analog)
    arch_id="google-lm",
    family="dense",
    source="paper-analog: GoogleNet (arXiv:1409.4842)",
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=512,
    scan_layers=False,
)

PAPER_ZOO = {c.arch_id: c for c in (SQUEEZE_LM, MID_LM, GOOGLE_LM)}
