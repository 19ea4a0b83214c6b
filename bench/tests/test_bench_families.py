"""Model families found by name (``manifest.family``): the two families'
weights and reference logits bit for bit as they were before their code
moved into ``bench/families/`` and ``bench/reference/<family>.py``, a new
family taken from new files alone, and an unknown one refused."""
from __future__ import annotations

import hashlib

import pytest

torch = pytest.importorskip("torch")

from conftest import small_config, stated_widths  # noqa: E402

from bench.harness import manifest  # noqa: E402
from bench.harness.weights import layout, leaves, make_weights  # noqa: E402
from bench.reference import logits_at  # noqa: E402
from bench.reference.layers import act, rms_norm  # noqa: E402

SEED = 2**33 + 71

#: sha256 (first 32 hex digits) of the small configurations' float32 weights and the
#: reference's logits, recorded by the same code from the harness as it was before the
#: families moved into files of their own (weights and the reference each in one module).
#: The same on torch 2.11 and 2.13; bf16 draws on the CPU differ between those releases, so
#: the served dtype's own draws are held on the card (equal gaps on equal seeds) instead.
DIGESTS = {
    ("dense", "weights"): "0e5d95676ea9652055867373b92a6607",
    ("dense", "f32"): "7e1a8e519d25b5c5f7a663bada6ec977",
    ("dense", "fp8"): "b090d2789a28207214b6c0544eb199e7",
    ("ssm", "weights"): "54bfb0aaa0702c27a39929af35c2d860",
    ("ssm", "f32"): "d833d562ee92f4fbc72c63e19d507207",
    ("ssm", "fp8"): "65bf9e75c648754bcf2ec18f3379ff3e",
}


def _digest(named) -> str:
    h = hashlib.sha256()
    for name, t in named:
        t = t.detach().contiguous()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:32]


def _logits(c, precision):
    w = make_weights(c, SEED, "cpu", torch.float32)
    g = torch.Generator().manual_seed(11)
    seqs = [torch.randint(0, c["vocab_size"], (S,), generator=g) for S in (37, 70)]
    return logits_at(c, w, seqs, [torch.arange(len(s)) for s in seqs], precision,
                     trunk=manifest.family(c).reference.trunk)


@pytest.mark.parametrize("name", ["dense", "ssm"])
def test_weights_are_bit_for_bit_as_before(name):
    w = make_weights(small_config(name), SEED, "cpu", torch.float32)
    assert _digest((str(p), t) for p, t in leaves(w)) == DIGESTS[(name, "weights")]


@pytest.mark.parametrize("precision", ["f32", "fp8"])
@pytest.mark.parametrize("name", ["dense", "ssm"])
def test_reference_logits_are_bit_for_bit_as_before(name, precision):
    out = _logits(small_config(name), precision)
    assert _digest((str(i), t) for i, t in enumerate(out)) == DIGESTS[(name, precision)]


# a family that no file of the benchmark knows: pre-norm gated-MLP layers with residuals,
# no attention, no SSD
TOY_MODEL = '''
from bench.harness.weights import Leaf, proj

WIDTHS = ("num_layers", "d_model", "d_ff", "vocab_size")


def layout(c):
    d, f = c["d_model"], c["d_ff"]
    return {"layers": [{"ln": {"scale": Leaf((d,), "ones")},
                        "mlp": {"w_gate": proj(d, d, f), "w_up": proj(d, d, f),
                                "w_down": proj(f, f, d)}} for _ in range(c["num_layers"])]}


def matmul_weights(c):
    return c["num_layers"] * 3 * c["d_model"] * c["d_ff"]


def attention(c):
    return 0, 0, 0, 0


def ssd_blocks(c):
    return 0
'''
TOY_REFERENCE = '''
from .layers import act, matmul, rms_norm, to_f32


def trunk(c, weights, hs, precision):
    for lp in weights["layers"]:
        p = to_f32(lp)
        m = p["mlp"]

        def mlp(x):
            x = rms_norm(x, p["ln"]["scale"], c["norm_eps"])
            g = act(c["activation"], matmul(x, m["w_gate"], precision))
            return matmul(g * matmul(x, m["w_up"], precision), m["w_down"], precision)

        hs = [h + mlp(h) for h in hs]
    return hs
'''
TOY = dict(name="toy", family="toy", num_layers=2, d_model=8, d_ff=16, vocab_size=10,
           norm="rmsnorm", norm_eps=1e-5, activation="silu", tie_embeddings=False)


@pytest.fixture
def toy_dirs(tmp_path, monkeypatch):
    for sub, text in (("families", TOY_MODEL), ("reference", TOY_REFERENCE)):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "toy.py").write_text(text)
    monkeypatch.setattr(manifest, "FAMILIES", tmp_path / "families")
    monkeypatch.setattr(manifest, "REFERENCE", tmp_path / "reference")
    return tmp_path


def test_a_new_family_needs_new_files_only(toy_dirs):
    c = dict(TOY)
    assert stated_widths(c) == {"num_layers": 2, "d_model": 8, "d_ff": 16, "vocab_size": 10}
    # the layout: embedding, final norm and unembedding first, then the family's layers
    shapes = [(p, leaf.shape) for p, leaf in leaves(layout(c))]
    assert shapes[:3] == [(("embed",), (10, 8)), (("ln_f", "scale"), (8,)),
                          (("lm_head",), (8, 10))]
    assert shapes[3:7] == [(("layers", 0, "ln", "scale"), (8,)),
                           (("layers", 0, "mlp", "w_gate"), (8, 16)),
                           (("layers", 0, "mlp", "w_up"), (8, 16)),
                           (("layers", 0, "mlp", "w_down"), (16, 8))]
    assert len(shapes) == 3 + 2 * 4
    # the reference: the toy's trunk between the shared embedding and head, by hand
    w = make_weights(c, 3, "cpu", torch.float32)
    seq = torch.tensor([1, 4, 9, 0, 2])
    got = logits_at(c, w, [seq], [torch.arange(5)], trunk=manifest.family(c).reference.trunk)
    h = w["embed"][seq]
    for p in w["layers"]:
        x = rms_norm(h, p["ln"]["scale"], 1e-5)
        h = h + (act("silu", x @ p["mlp"]["w_gate"]) * (x @ p["mlp"]["w_up"])) @ p["mlp"]["w_down"]
    torch.testing.assert_close(got[0], rms_norm(h, w["ln_f"]["scale"], 1e-5) @ w["lm_head"])
    # the FLOP count: 2 a weight a token, the unembedding at the last position, nothing else
    m = manifest.load_module(manifest.BENCH / "metrics" / "_model.py")
    assert m.matmul_weights(c) == 2 * 3 * 8 * 16 == 768
    assert m.attention_sites(c) == 0
    assert m.batch_flops(c, 2, 5, 1) == 2 * 5 * 2 * 768 + 2 * 2 * 8 * 10
    # and a decode step after it: one token through every product and the unembedding
    assert m.batch_flops(c, 2, 5, 2) - m.batch_flops(c, 2, 5, 1) == 2 * (2 * 768 + 2 * 8 * 10)


def test_an_unknown_family_names_both_paths():
    with pytest.raises(ValueError) as e:
        manifest.family({"family": "no_such_family"})
    for path in (manifest.FAMILIES / "no_such_family.py",
                 manifest.REFERENCE / "no_such_family.py"):
        assert str(path) in str(e.value)
    with pytest.raises(ValueError, match="no model family"):
        manifest.family({"family": "../harness/cell"})

