"""The port's attention ablation (``ops/attention_ablate.py`` and
``diagnostics/attention_ablate.py``) against ``benchmarks/attention_ablate.py``,
on the CPU.

The JAX script has no package, so it is loaded by path; its module globals
(B, L, H, D, HD, SCALE and K_STEPS) are monkeypatched to small sizes, and its
Pallas kernel ``make_kernel(mode)`` runs in interpret mode (``pallas_call``
with ``interpret=True``; the script is not edited). The port's wrapper takes
its plain version because the tensors lie on the CPU. Inputs are made with
numpy from a seed, a key-padding bias in one row.

Tolerances, for each (batch, query) row against its own max |ref|: float32
max |d| <= 1e-6 * max(1, max |ref|) (float32 sums in another order; ``nosmax``
reaches 5e9 in the padded row and about 10 in the other); bf16 max |d| <= one
output ulp of the row's largest element, 2^(floor(log2 max(1, max |ref|)) - 7)
(a probability rounded to bf16 from float32 scores summed in another order can
land one bf16 step away, and so can the output's own rounding). ``nopv``
writes probabilities, each held to its own magnitude: |d| <= 1e-6 |ref| in
float32 and one bf16 ulp, 2^-7 |ref|, in bf16, plus 2^-24. ``aligned`` leaves
the columns past head_dim unwritten, so it is compared on the first head_dim
columns.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mdhs_tpu_torch.diagnostics import attention_ablate as tdiag
from mdhs_tpu_torch.ops import attention_ablate as taa
from mdhs_tpu_torch.ops import fused_attention as tfa

torch.set_num_threads(2)
SCRIPT = Path(__file__).resolve().parent.parent / "benchmarks" / "attention_ablate.py"
SHAPES = [(2, 128, 2, 64), (2, 64, 3, 32)]  # B, L, heads, head_dim


@pytest.fixture(scope="module")
def jab():
    spec = importlib.util.spec_from_file_location("benchmarks_attention_ablate", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _shrink(monkeypatch, jab, B, L, H, D, steps=None):
    for name, value in (("B", B), ("L", L), ("H", H), ("D", D), ("HD", H * D), ("SCALE", float(D) ** -0.5)):
        monkeypatch.setattr(jab, name, value)
    if steps is not None:
        monkeypatch.setattr(jab, "K_STEPS", steps)


def _inputs(B, L, HD, dtype, seed, pad=True):
    """q, k, v, bias as jnp arrays and as torch tensors holding the same values."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, HD)).astype(np.float32) for _ in range(3))
    bias = np.zeros((B, L), np.float32)
    if pad:
        bias[0, L - 5:] = -1e9  # the last 5 keys of row 0 are padding
    jdt = getattr(jnp, dtype)
    jx = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [jnp.asarray(bias)]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in jx[:3]]
    return jx, tx + [torch.from_numpy(bias)]


def _jax_kernel(jab, mode, q, k, v, bias):
    """The script's pallas_call of make_kernel(mode), as its build(mode).op makes it."""
    B, L, HD = q.shape
    row = pl.BlockSpec((1, L, HD), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    key = pl.BlockSpec((1, 1, L), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    with jax.default_matmul_precision("default"):
        out = pl.pallas_call(
            jab.make_kernel(mode), grid=(B,), in_specs=[row, row, row, key], out_specs=row,
            out_shape=jax.ShapeDtypeStruct((B, L, HD), q.dtype),
            scratch_shapes=[pltpu.VMEM((jab.H * L, L), jnp.float32), pltpu.VMEM((jab.H * L, L), q.dtype)],
            interpret=True,
        )(q, k, v, bias.reshape(B, 1, L))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("B, L, H, D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", taa.MODES)
def test_plain_version_matches_the_pallas_kernel_in_interpret_mode(jab, monkeypatch, mode, dtype, B, L, H, D):
    _shrink(monkeypatch, jab, B, L, H, D)
    jx, tx = _inputs(B, L, H * D, dtype, seed=L + H)
    ref = _jax_kernel(jab, mode, *jx)
    out = taa.attention_ablate_reference(*tx, H, float(D) ** -0.5, mode)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, L, H * D)
    out = out.float().numpy()
    if mode == "aligned":  # the columns past D are unwritten: NaN in interpret mode and in the plain version
        assert np.isnan(ref[..., D:]).all() and np.isnan(out[..., D:]).all()
        ref, out = ref[..., :D], out[..., :D]
    assert np.isfinite(ref).all()
    d = np.abs(out - ref)
    if mode == "nopv":
        frac = 1e-6 if dtype == "float32" else 2.0 ** -7
        excess = d - (frac * np.abs(ref) + 2.0 ** -24)
        assert excess.max() <= 0, excess.max()
    else:
        top = np.maximum(1.0, np.abs(ref).max(-1, keepdims=True))
        if dtype == "float32":
            bound = 1e-6 * top
        else:  # one bf16 ulp of the row's largest element: top = m 2^e with m in [0.5, 1)
            bound = np.ldexp(1.0, np.frexp(top)[1] - 8)
        excess = d - bound
        assert excess.max() <= 0, excess.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_is_fused_attentions_plain_version(dtype):
    _, (q, k, v, bias) = _inputs(2, 96, 256, str(dtype).split(".")[1], seed=5)
    args = (q, k, v, bias, 4, 0.125)
    assert torch.equal(taa.attention_ablate_reference(*args, "full"), tfa.attention_reference(*args))


@pytest.mark.parametrize("mode", taa.MODES)
def test_wrapper_takes_the_plain_version_on_the_cpu(mode):
    _, (q, k, v, bias) = _inputs(2, 64, 96, "bfloat16", seed=6)
    args = (q, k, v, bias, 3, 32 ** -0.5, mode)
    n = taa.attention_ablate.launches
    out, ref = taa.attention_ablate(*args), taa.attention_ablate_reference(*args)
    assert torch.equal(out.isnan(), ref.isnan()) and torch.equal(out.nan_to_num(), ref.nan_to_num())
    assert taa.attention_ablate.launches == n


@pytest.mark.parametrize("mode, args, ok", [
    ("full", (torch.bfloat16, 128, 768, 12), True),     # the TPU script's shape
    ("nopv", (torch.bfloat16, 128, 768, 12), True),
    ("nopv", (torch.bfloat16, 64, 768, 12), True),      # L == head_dim
    ("nopv", (torch.bfloat16, 63, 768, 12), False),     # fewer keys than head_dim: no D keys to store
    ("full", (torch.bfloat16, 63, 768, 12), True),
    ("nosmax", (torch.bfloat16, 500, 768, 12), True),   # fused_attention's gate: ragged L
    ("aligned", (torch.bfloat16, 513, 768, 12), False), # past max_position_embeddings
    ("nomax", (torch.bfloat16, 128, 1024, 4), False),   # head_dim 256
    ("aligned", (torch.bfloat16, 128, 384, 32), False), # head_dim 12 is not a multiple of 8
    ("full", (torch.float32, 128, 768, 12), False),
])
def test_supports(mode, args, ok):
    assert taa.supports(mode, *args) is ok


def test_unknown_mode_raises():
    _, (q, k, v, bias) = _inputs(1, 16, 64, "float32", seed=7)
    with pytest.raises(ValueError, match="unknown mode"):
        taa.attention_ablate(q, k, v, bias, 2, 0.125, "nosoftmax")
    with pytest.raises(ValueError, match="unknown mode"):
        taa.attention_ablate_reference(q, k, v, bias, 2, 0.125, "nosoftmax")
    with pytest.raises(ValueError, match="unknown mode"):
        taa.supports("nosoftmax", torch.bfloat16, 128, 768, 12)
    with pytest.raises(ValueError, match="unknown mode"):
        tdiag.build("nosoftmax", "cpu")


def test_nopv_with_fewer_keys_than_head_dim_raises():
    _, (q, k, v, bias) = _inputs(1, 16, 64, "float32", seed=8)
    with pytest.raises(ValueError, match="L >= head_dim"):
        taa.attention_ablate(q, k, v, bias, 2, 0.125, "nopv")


@pytest.mark.parametrize("mode", ["full", "nomax", "nosmax", "nopv"])
def test_chain_matches_the_jax_chain(jab, monkeypatch, interpret, mode):
    """build(mode)'s scalar: K_STEPS = 3 calls on q + t * 1e-3 (bf16), zero bias,
    each output summed in float32. aligned is left out: its unwritten columns
    are NaN on the JAX side and in the plain version."""
    B, L, H, D = 2, 64, 3, 32
    _shrink(monkeypatch, jab, B, L, H, D, steps=3)
    monkeypatch.setattr(tdiag, "K_STEPS", 3)
    jx, tx = _inputs(B, L, H * D, "bfloat16", seed=9, pad=False)
    ref = float(jab.build(mode)(*jx))
    chain = tdiag.build(mode, "cpu", B, L, H, D)
    n = taa.attention_ablate.launches
    out = chain(*tx)
    assert out.dtype == torch.float32 and out.shape == () and chain.steps == 3
    assert taa.attention_ablate.launches == n
    np.testing.assert_allclose(out.item(), ref, rtol=1e-3)


def test_chain_offsets_round_as_jax_does():
    for dtype in (torch.bfloat16, torch.float32):
        t = np.arange(20)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        ref = np.asarray((jnp.asarray(t).astype(jdt) * 1e-3).astype(jnp.float32))
        np.testing.assert_array_equal(tdiag._offsets(dtype, torch.device("cpu"), 20).float().numpy(), ref)


def test_chain_rejects_other_shapes():
    chain = tdiag.build("full", "cpu", 2, 64, 3, 32)
    _, (q, k, v, bias) = _inputs(2, 64, 64, "bfloat16", seed=10)
    with pytest.raises(ValueError, match="expected"):
        chain(q, k, v, bias)


def test_main_on_the_cpu_prints_each_mode(monkeypatch, capsys):
    for name, value in (("B", 2), ("L", 64), ("H", 3), ("D", 32), ("HD", 96), ("K_STEPS", 2)):
        monkeypatch.setattr(tdiag, name, value)
    assert tdiag.main(["--device", "cpu", "--seed", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    header = json.loads(lines[0])
    assert header["device"] == "cpu" and header["k_steps"] == 2
    rows = [json.loads(x) for x in lines[2::2]]
    assert [x.split(":")[0].strip() for x in lines[1::2]] == list(taa.MODES)
    assert [r["mode"] for r in rows] == list(taa.MODES) and all(r["ms_per_op"] > 0 for r in rows)
    assert all(np.isfinite(r["chain_value"]) for r in rows if r["mode"] != "aligned")
    assert all("kernel_device_ms" not in r for r in rows)  # no device time from a CPU run
