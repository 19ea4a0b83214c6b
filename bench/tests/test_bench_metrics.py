"""The metrics' arithmetic against counts made by hand, one shape per kernel,
and the trace reduction and the end-to-end metrics on made-up runs."""
from __future__ import annotations

import pytest

from bench.harness import spans
from bench.harness.cell import Batch, Run
from bench.harness.manifest import BENCH, load_module
from bench.harness.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from bench.harness.trace import HOST_ONLY

np = pytest.importorskip("numpy")


def summarize(device_events, host_events, window):
    """The trace of (name, start, end) device and host events, with no
    launch ids and no program span (``spans.summarize``'s first half)."""
    return spans.summarize([(n, a, b, 0, False) for n, a, b in device_events],
                           [(n, a, b, 0) for n, a, b in host_events], window)[0]


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py")


def e2e(name):
    return load_module(BENCH / "e2e" / f"{name}.py")


DENSE = dict(family="dense", num_layers=2, d_model=8, num_heads=4, num_kv_heads=2, head_dim=8,
             d_ff=16, vocab_size=10)
SSM = dict(family="ssm", num_layers=3, d_model=2, vocab_size=10, ssm_expand=2, ssm_headdim=2,
           ssm_ngroups=1, ssm_state=3, ssd_chunk=4)


def test_flash_launch_by_hand():
    # B=2, H=4, KV=2, S=3, hd=8: q and out 2*3*4*8 bf16 each, k and v 2*3*2*8 each;
    # 6 causal pairs a head and prompt, 2*8 FLOPs for q.k and 2*8 for p.v
    nbytes, flops = metric("flash_roofline.prefill").launch(DENSE, 2, 3)
    assert nbytes == 2 * (2 * 3 * 4 * 8 * 2) + 2 * (2 * 3 * 2 * 8 * 2) == 1152
    assert flops == 2 * 4 * 6 * 32 == 1536


def test_ssd_launch_by_hand():
    # d=2, expand 2: di=4, P=2 -> H=2 heads; G=1, N=3; chunk 4; B=1, S=5 -> chunks of 4 and 1.
    # A chunk of l: C.B^T on l(l+1)/2 pairs x 2N (one group), the weighted sum with x on the
    # same pairs x 2P a head, y from the carried state and the chunk's state 2NP a token each
    ssd = metric("ssd_roofline.prefill")
    pairs = {l: l * (l + 1) // 2 for l in (4, 1)}
    per_chunk = {l: pairs[l] * 2 * 3 + 2 * (pairs[l] * 2 * 2 + 2 * 2 * 3 * 2 * l) for l in pairs}
    nbytes, flops = ssd.launch(SSM, 1, 5)
    assert flops == per_chunk[4] + per_chunk[1] == 394
    # x and y 5*2*2 bf16, dt 5*2 bf16, A 2 f32, B and C 5*3 bf16, the final state 2*3*2 f32
    assert nbytes == 2 * (5 * 2 * 2 * 2) + 5 * 2 * 2 + 2 * 4 + 2 * (5 * 3 * 2) + 2 * 3 * 2 * 4


def test_model_flops_by_hand():
    m = load_module(BENCH / "metrics" / "_model.py")
    # a layer: q 8x32, k and v 8x16 each, o 32x8, gate and up 8x16, down 16x8: 1152 weights
    assert m.matmul_weights(DENSE) == 2 * (8 * 32 + 2 * 8 * 16 + 32 * 8 + 3 * 8 * 16) == 2304
    # B=1, S=3, one token: 2 FLOPs a weight a token, the unembedding at the last position,
    # 6 causal pairs x 4 heads x 32 FLOPs in each of 2 layers
    assert m.batch_flops(DENSE, 1, 3, 1) == 3 * 2 * 2304 + 2 * 8 * 10 + 2 * 4 * 6 * 32
    # one decode step after it: a token through every product and the unembedding,
    # attention over 4 positions
    assert m.batch_flops(DENSE, 1, 3, 2) - m.batch_flops(DENSE, 1, 3, 1) == \
        2 * 2304 + 2 * 8 * 10 + 2 * 4 * 4 * 32
    # ssm: 3 blocks of in_proj 2x(8+6+2) and out_proj 4x2, no attention
    assert m.attention_sites(SSM) == 0
    assert m.matmul_weights(SSM) == 3 * (2 * 16 + 4 * 2) == 120
    # B=1, S=5, one token: the products, the unembedding at the last position, and the
    # chunked SSD of each block (394 FLOPs, test_ssd_launch_by_hand)
    assert m.batch_flops(SSM, 1, 5, 1) == 5 * 2 * 120 + 2 * 2 * 10 + 3 * 394


def _run(batches, cfg=DENSE, trace=None, window=2.0):
    return Run(cfg, batches, window, 1.0, trace)


def _batch(i, S, B=8, new=1, t=(0.0, 1.0)):
    return Batch(i, S, B, new, t[0], t[1], np.zeros((B, new), dtype=np.int32))


def test_end_to_end_metrics():
    bs = [_batch(0, 100, t=(0.0, 0.5)), _batch(1, 300, t=(0.5, 2.0))]
    assert e2e("prefill_tok_s").value(_run(bs)) == (800 + 2400) / 2.0
    assert e2e("ttft_p95_ms").value(_run(bs)) == pytest.approx(1500.0)
    assert e2e("ttft_p95_ms").value(_run([_batch(0, 10, new=3)])) is None


def test_trace_reduction():
    dev = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0), ("outside", 20.0, 21.0)]
    host = [("aten::mm", 3.2, 4.5), ("cudaLaunchKernel", 3.4, 3.6), ("aten::add", 6.5, 9.5)]
    t = summarize(dev, host, (0.0, 10.0))
    assert t.busy_s == pytest.approx(3.0) and t.window_s == 10.0
    assert dict(t.op_seconds) == pytest.approx({"k1": 2.0, "k2": 1.5})
    # gaps [0, 1] (no op), [3, 5] (mid 4.0: aten::mm), [6, 10] (mid 8.0: aten::add)
    assert dict(t.idle_seconds) == pytest.approx(
        {HOST_ONLY: 1.0, "aten::mm": 2.0, "aten::add": 4.0})
    assert t.launches == 3
    assert metric("idle_share.prefill").read(_run([], trace=t)) == pytest.approx(70.0)


def test_rooflines_read_the_trace():
    S, B = 1024, 8
    nbytes, flops = metric("flash_roofline.prefill").launch(DENSE, B, S)
    least = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    # each of the 2 layers' launches took twice its least time
    ops = [("flash_attention_wgmma_kernel<128>", i * 1.0, 2 * least) for i in range(2)]
    t = summarize([(n, s, s + d) for n, s, d in ops], [], (0.0, 10.0))
    assert metric("flash_roofline.prefill").read(_run([_batch(0, S)], trace=t)) == \
        pytest.approx(50.0)
    # no launch of the kernel: nothing to read
    assert metric("flash_roofline.prefill").read(
        _run([_batch(0, S)], trace=summarize([], [], (0.0, 1.0)))) is None


def test_elementwise_classes():
    ew = metric("elementwise_ns_per_tok.prefill")
    assert ew.kind("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT") == "matmul"
    assert ew.kind("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64") == "matmul"
    assert ew.kind("void flash_attention_wgmma_kernel<128>(CUtensorMap)") == "flash_attention"
    assert ew.kind("void ssd_scan_wgmma_kernel<64>(CUtensorMap)") == "ssd_scan"
    assert ew.kind("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert ew.kind("void at::native::vectorized_elementwise_kernel<4, ...>") == "elementwise"
    t = summarize([("nvjet_a", 0.0, 1.0), ("elementwise_b", 1.0, 1.5)], [], (0.0, 2.0))
    assert ew.read(_run([_batch(0, 100)], trace=t)) == pytest.approx(0.5e9 / 800)


def test_mfu_reads_the_traced_window():
    bs = [_batch(0, 3, B=1)]
    m = load_module(BENCH / "metrics" / "_model.py")
    t = summarize([("k", 0.0, 0.1)], [], (0.0, 0.5))
    # the traced window's 0.5 s, not the host's window of the run (2 s here)
    assert metric("mfu.prefill").read(_run(bs, trace=t)) == pytest.approx(
        100 * m.batch_flops(DENSE, 1, 3, 1) / (0.5 * BF16_FLOP_PER_S))
    assert metric("mfu.prefill").read(_run(bs)) is None
