"""The plain reference against the program at small widths, on the CPU.

The reference (``bench/reference``) is written apart from the program; on
the same weights and tokens in float32 its logits have to agree with the
program's teacher-forced forward, and with what the program serves through
its prefill and its decode cache.  Its layers are held to textbook forms:
the chunked SSD to the scan's plain recurrence, RoPE to a rotation of
each channel pair.
"""
from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

from conftest import program_config, small_config  # noqa: E402

from bench.harness import manifest  # noqa: E402
from bench.harness.weights import make_weights  # noqa: E402
from bench.reference import logits_at  # noqa: E402
from bench.reference.layers import causal_attention, rope, softplus, ssd  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _program(c, seed):
    from repro_torch.models import Model

    model = Model(program_config(c))
    return model, make_weights(c, seed, "cpu", torch.float32)


@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("S", [37, 70])
def test_reference_equals_the_program_forward(family, S):
    c = small_config(family)
    model, w = _program(c, 5)
    tokens = torch.randint(0, c["vocab_size"], (2, S), generator=torch.Generator().manual_seed(S))
    with torch.no_grad():
        want, _ = model.forward(w, {"tokens": tokens})
    got = logits_at(c, w, list(tokens), [torch.arange(S)] * 2,
                    trunk=manifest.family(c).reference.trunk)
    for b in range(2):
        torch.testing.assert_close(got[b], want[b].float(), **TOL)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_reference_equals_prefill_then_decode(family):
    """Prefill then decode steps through the program's cache give the logits
    the reference gives at those positions of one whole forward."""
    c = small_config(family)
    model, w = _program(c, 9)
    B, S, steps = 2, 45, 6
    tokens = torch.randint(0, c["vocab_size"], (B, S + steps),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        cache = model.init_cache(B, S + steps, device="cpu")
        lg, cache = model.prefill(w, {"tokens": tokens[:, :S]}, cache)
        got = [lg[:, -1]]
        for j in range(steps - 1):
            lg, cache = model.decode_step(w, tokens[:, S + j:S + j + 1], cache)
            got.append(lg[:, -1])
    got = torch.stack(got, dim=1)
    ref = logits_at(c, w, list(tokens[:, :S + steps - 1]),
                    [torch.arange(S - 1, S + steps - 1)] * B,
                    trunk=manifest.family(c).reference.trunk)
    for b in range(B):
        torch.testing.assert_close(ref[b], got[b].float(), **TOL)


def test_ssd_equals_its_recurrence():
    g = torch.Generator().manual_seed(0)
    S, H, P, G, N = 77, 4, 8, 2, 6
    x = torch.randn(S, H, P, generator=g, dtype=torch.float64)
    dt = softplus(torch.randn(S, H, generator=g, dtype=torch.float64))
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    B = torch.randn(S, G, N, generator=g, dtype=torch.float64)
    C = torch.randn(S, G, N, generator=g, dtype=torch.float64)
    h = torch.zeros(H, N, P, dtype=torch.float64)
    want = []
    for t in range(S):
        Bh = B[t].repeat_interleave(H // G, 0)
        Ch = C[t].repeat_interleave(H // G, 0)
        inp = dt[t][:, None, None] * Bh[:, :, None] * x[t][:, None, :]
        h = torch.exp(dt[t] * A)[:, None, None] * h + inp
        want.append(torch.einsum("hn,hnp->hp", Ch, h))
    for chunk in (16, 64):
        torch.testing.assert_close(ssd(x, dt, A, B, C, chunk=chunk), torch.stack(want))


def test_rope_rotates_each_pair():
    x = torch.randn(5, 2, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    y = rope(x, 100.0)
    for pos in range(5):
        for i in range(4):
            a = pos * 100.0 ** (-i / 4)
            c, s = math.cos(a), math.sin(a)
            torch.testing.assert_close(y[pos, :, i], x[pos, :, i] * c - x[pos, :, i + 4] * s)
            torch.testing.assert_close(y[pos, :, i + 4], x[pos, :, i + 4] * c + x[pos, :, i] * s)


def test_attention_is_causal_and_grouped():
    g = torch.Generator().manual_seed(2)
    S, H, KV, hd = 300, 4, 2, 8
    q, k, v = (torch.randn(S, n, hd, generator=g, dtype=torch.float64) for n in (H, KV, KV))
    got = causal_attention(q, k, v, block=64)
    for h in range(H):
        s = q[:, h] @ k[:, h // 2].T / math.sqrt(hd)
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
        torch.testing.assert_close(got[:, h], torch.softmax(s, -1) @ v[:, h // 2])
