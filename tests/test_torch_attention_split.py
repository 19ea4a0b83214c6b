"""Split-K decode and the flash route rule, on the CPU.

The decode kernel (``csrc/decode_attention.cu``) cuts the cache axis T
into spans, reduces each span to f32 partials (m, l, acc) and combines the
spans in span order.  ``decode_split_ref`` below is the plain PyTorch form
of that arithmetic; it is held against the unsplit plain version
(``decode_attention_ref``) and against the reference's Pallas
``decode_attention`` in interpret mode, on seeded numpy inputs.

Tolerance: f32 ``rtol=1e-5, atol=1e-6`` between the split and the unsplit
forms (they differ only in where the online softmax rescales), and against
the Pallas kernel (whose key blocks rescale elsewhere again).  A span with
no valid position must drop out exactly, and a row with no valid position
must be zeros in both forms.

The flash wrapper's route rule (``flash_route``) and its TMA stride check
(``tma_strides``) are plain Python and are pinned here too; the split rule
(``decode_splits``) is pinned at the serving shapes.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as j_decode  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TILE,
    decode_attention_ref,
    decode_splits,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    NEG_INF,
    flash_route,
    tma_strides,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def decode_split_ref(q, k, v, valid, n_split):
    """Plain split-K decode, kernel layout (q (B, KV, rep, hd), k/v
    (B, KV, T, hd), valid (B, T) bool), f32: spans of ``ceil(T / n_split)``
    positions (the last one ragged), each reduced to (m, l, acc) with the
    Pallas masking, then combined in span order."""
    T, hd = k.shape[2], q.shape[-1]
    span = -(-T // n_split)
    q, k, v = q.float(), k.float(), v.float()
    parts = []
    for t0 in range(0, T, span):
        s = torch.einsum("bgrd,bgtd->bgrt", q, k[:, :, t0:t0 + span]) * (1.0 / math.sqrt(hd))
        ok = valid[:, None, None, t0:t0 + span]
        s = torch.where(ok, s, NEG_INF)
        m = s.amax(-1, keepdim=True)                      # NEG_INF when nothing is valid
        p = torch.where(ok, torch.exp(s - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True), p @ v[:, :, t0:t0 + span]))
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:                                 # span order
        w = torch.exp(m - M)
        L = L + l * w
        acc = acc + a * w
    return acc / torch.where(L > 0, L, 1.0)


def _inputs(B, KV, rep, T, hd, seed, p_valid=0.7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, rep, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    valid = rng.random((B, T)) < p_valid
    valid[:, 0] = True
    return q, k, v, valid


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
def test_split_decode_matches_unsplit_and_pallas(n_split, rep):
    """T = 150 gives ragged spans for every n_split > 1 (150 = 7 x 22 - 4)."""
    B, KV, T, hd = 2, 2, 150, 32
    q, k, v, valid = _inputs(B, KV, rep, T, hd, seed=17 * n_split + rep)
    qt, kt, vt, mt = _torch(q, k, v, valid)
    got = decode_split_ref(qt, kt, vt, mt, n_split)
    np.testing.assert_allclose(got.numpy(), decode_attention_ref(qt, kt, vt, mt).numpy(), **TOL)
    pallas = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
                      block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("n_split", [2, 3, 7])
def test_split_decode_invalid_span_and_row(n_split):
    """A whole span with no valid position drops out of the combine (the
    result equals the unsplit form); a row with no valid position anywhere
    gives exactly zeros in both forms."""
    B, KV, rep, T, hd = 3, 2, 4, 140, 16
    q, k, v, valid = _inputs(B, KV, rep, T, hd, seed=40 + n_split)
    span = -(-T // n_split)
    valid[1, :span] = False          # the first span of row 1: nothing valid
    valid[1, span] = True
    valid[2, span:] = False          # row 2: only its first span holds valid positions
    valid[0] = False                 # row 0: nothing valid at all
    qt, kt, vt, mt = _torch(q, k, v, valid)
    got = decode_split_ref(qt, kt, vt, mt, n_split).numpy()
    want = decode_attention_ref(qt, kt, vt, mt).numpy()
    assert np.all(got[0] == 0.0) and np.all(want[0] == 0.0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "B,KV,T,want",
    [
        (8, 4, 1056, (9, 128)),      # yi-9b's decode launch: 288 blocks
        (8, 32, 2080, (2, 1088)),    # zamba2-1.2b's: 512 blocks
        (1, 1, 5, (1, TILE)),
        (8, 4, 0, (1, TILE)),
    ],
)
def test_decode_splits_at_the_serving_shapes(B, KV, T, want):
    assert decode_splits(B, KV, T) == want


@pytest.mark.parametrize("B,KV", [(1, 1), (2, 4), (8, 4), (8, 32), (64, 8)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 700, 1056, 4097])
def test_decode_splits_cover_the_cache(B, KV, T):
    """Spans are whole tiles, every span holds a position, they cover T, and
    the grid reaches two waves of 132 SMs unless T has too few tiles."""
    n, span = decode_splits(B, KV, T)
    assert span % TILE == 0 and n >= 1
    assert (n - 1) * span < T <= n * span
    assert B * KV * n >= 2 * 132 or n == -(-T // TILE) or span == TILE


@pytest.mark.parametrize(
    "dtype,hd,route",
    [
        (torch.bfloat16, 64, "wgmma"),
        (torch.bfloat16, 128, "wgmma"),
        (torch.float32, 64, "simt"),
        (torch.float32, 128, "simt"),
        (torch.bfloat16, 32, "simt"),
        (torch.bfloat16, 96, "simt"),
        (torch.bfloat16, 160, "simt"),
        (torch.bfloat16, 256, "simt"),
    ],
)
def test_flash_route_rule(dtype, hd, route):
    """bf16 at hd 64/128 goes to the tensor-core kernel; f32 and every other
    head dim to the CUDA-core kernel."""
    assert flash_route(dtype, hd) == route


def test_tma_strides_take_model_layout_views_and_refuse_misalignment():
    B, S, H, hd = 2, 40, 4, 64
    x = torch.zeros((B, S, H, hd), dtype=torch.bfloat16)
    view = x.transpose(1, 2)  # the kernel layout (B, H, S, hd) over the model's tensor
    assert tma_strides("f", "q", view) == [S * H * hd, hd, H * hd]
    one = torch.zeros((1, H, S, hd), dtype=torch.bfloat16)
    past = one.numel()  # the batch axis has size 1: its stride is set one past the tensor
    assert tma_strides("f", "q", one)[0] == past
    wide = torch.zeros((B, H, S, hd + 4), dtype=torch.bfloat16)[..., :hd]  # rows of 136 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tma_strides("f", "q", wide)
    flat = torch.zeros(B * H * S * hd + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + B * H * S * hd].view(B, H, S, hd)  # base 2 bytes past alignment
    assert flat.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte boundary"):
        tma_strides("f", "q", shifted)
