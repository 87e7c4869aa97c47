"""mdhs_tpu_torch ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages. The
Pallas kernels do not lower on the CPU, so the JAX side runs its plain
``*_reference`` functions; the port's wrappers take their plain versions
because the tensors lie on the CPU. Weights are handed to the port in
nn.Linear layout (the transpose of the JAX kernels' (in, out)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.ops import attention_block as jab
from mdhs_tpu.ops import ffn_block as jfb
from mdhs_tpu.ops import gelu as jgelu
from mdhs_tpu.ops import preprocess as jpp
from mdhs_tpu_torch.ops import attention_block as tab
from mdhs_tpu_torch.ops import ffn_block as tfb
from mdhs_tpu_torch.ops import gelu as tgelu
from mdhs_tpu_torch.ops import preprocess as tpp

torch.set_num_threads(2)

LN_EPS = 1e-12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sublayer_params(rng, h, inner, out_in):
    """(in, out) kernels in the JAX layout, with LayerNorm affine params:
    x @ w_in is (.., inner); w_out maps out_in features back to h."""
    return dict(
        w_in=(rng.standard_normal((h, inner)) * 0.1).astype(np.float32),
        b_in=(rng.standard_normal(inner) * 0.05).astype(np.float32),
        w_out=(rng.standard_normal((out_in, h)) * 0.1).astype(np.float32),
        b_out=(rng.standard_normal(h) * 0.05).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32),
        beta=(0.1 * rng.standard_normal(h)).astype(np.float32),
    )


@pytest.mark.parametrize("entry", ["reference", "wrapper"])
@pytest.mark.parametrize("L", [16, 128])
def test_attention_block_matches_jax_reference(L, entry):
    B, HD, H = 2, 64, 4
    scale = float(HD // H) ** -0.5
    rng = np.random.default_rng(L)
    x = rng.standard_normal((B, L, HD)).astype(np.float32)
    p = _sublayer_params(rng, HD, 3 * HD, HD)
    mask = np.ones((B, L), np.float32)
    mask[0, L - 3:] = 0.0
    mask[1, L - L // 4:] = 0.0
    bias = ((1.0 - mask) * -1e9).astype(np.float32)

    jargs = (x, p["w_in"], p["b_in"], p["w_out"], p["b_out"], p["gamma"], p["beta"], bias)
    ref = np.asarray(jab.attention_block_reference(*map(jnp.asarray, jargs), H, scale, LN_EPS))

    targs = (_t(x), _t(p["w_in"].T), _t(p["b_in"]), _t(p["w_out"].T), _t(p["b_out"]),
             _t(p["gamma"]), _t(p["beta"]), _t(bias))
    launches = tab.attention_block.launches
    fn = tab.attention_block_reference if entry == "reference" else tab.attention_block
    out = fn(*targs, H, scale, LN_EPS)
    assert out.dtype == torch.float32 and out.shape == (B, L, HD)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # a CPU tensor takes the plain version, which launches nothing
    assert tab.attention_block.launches == launches


@pytest.mark.parametrize("entry", ["reference", "wrapper"])
@pytest.mark.parametrize("act", ["erf", "tanh"])
def test_ffn_block_matches_jax_reference(act, entry):
    N, H, Di = 48, 64, 128
    rng = np.random.default_rng(1 if act == "erf" else 2)
    x = rng.standard_normal((N, H)).astype(np.float32)
    p = _sublayer_params(rng, H, Di, Di)
    jargs = (x, p["w_in"], p["b_in"], p["w_out"], p["b_out"], p["gamma"], p["beta"])
    ref = np.asarray(jfb.ffn_block_reference(*map(jnp.asarray, jargs), LN_EPS, act))

    targs = (_t(x), _t(p["w_in"].T), _t(p["b_in"]), _t(p["w_out"].T), _t(p["b_out"]),
             _t(p["gamma"]), _t(p["beta"]))
    launches = tfb.ffn_block.launches
    fn = tfb.ffn_block_reference if entry == "reference" else tfb.ffn_block
    out = fn(*targs, LN_EPS, act)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    assert tfb.ffn_block.launches == launches


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_pipeline_matches_jax_exactly(dtype, normalize):
    imgs = np.random.default_rng(3).integers(0, 256, (3, 40, 36, 3), dtype=np.uint8)
    ref = jpp.eval_pipeline(jnp.asarray(imgs), 32, normalize=normalize, dtype=getattr(jnp, dtype))
    out = tpp.eval_pipeline(_t(imgs), 32, normalize=normalize, dtype=getattr(torch, dtype))
    assert out.shape == (3, 3, 32, 32) and out.dtype == getattr(torch, dtype)
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        out.permute(0, 2, 3, 1).float().numpy(), np.asarray(ref.astype(jnp.float32))
    )


def test_center_crop_is_the_jax_window():
    x = np.arange(2 * 9 * 7 * 3).reshape(2, 9, 7, 3)
    np.testing.assert_array_equal(tpp.center_crop(_t(x), 4).numpy(), np.asarray(jpp.center_crop(jnp.asarray(x), 4)))


@pytest.mark.parametrize("act", ["erf", "tanh"])
def test_gelu_matches_jax_f32(act):
    x = np.linspace(-8.0, 8.0, 20001, dtype=np.float32)
    if act == "erf":
        ref = np.asarray(jgelu.exact_gelu(jnp.asarray(x)))
    else:
        ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    out = tgelu.gelu(_t(x), act)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_gelu_keeps_bf16_dtype_and_rejects_unknown_act():
    x = torch.linspace(-3, 3, 64, dtype=torch.bfloat16)
    assert tgelu.exact_gelu(x).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tgelu.gelu(x, "relu")


@pytest.mark.parametrize("args, ok", [
    ((torch.bfloat16, 128, 768, 12), True),   # MIBF at bench.py's seq length
    ((torch.bfloat16, 256, 768, 12), True),   # configs/mibf/mibf_ham.yml
    ((torch.bfloat16, 1, 768, 12), True),
    ((torch.bfloat16, 100, 768, 12), True),   # ragged L: the kernel masks it
    ((torch.bfloat16, 320, 768, 12), True),   # largest L whose tile fits 227 KB at head_dim 64
    ((torch.bfloat16, 336, 768, 12), False),
    ((torch.bfloat16, 512, 768, 12), False),  # BERT takes fused_attention there
    ((torch.float32, 128, 768, 12), False),   # float32 parity path -> plain
    ((torch.bfloat16, 128, 64, 4), False),    # hidden not a multiple of 128
    ((torch.bfloat16, 128, 768, 10), False),  # 768 % 10 != 0
    ((torch.bfloat16, 128, 384, 32), False),  # head_dim 12 is not a multiple of 8
    ((torch.bfloat16, 128, 1024, 16), True),  # BERT-large widths
    ((torch.bfloat16, 128, 1280, 20), False),  # wider than the row-LayerNorm block
])
def test_attention_block_supports(args, ok):
    assert tab.supports(*args) is ok


@pytest.mark.parametrize("args, ok", [
    ((torch.bfloat16, 4096, 768, 3072), True),  # batch 32 x seq 128
    ((torch.bfloat16, 128, 768, 3072), True),   # batch 1: no n_rows >= 1024 floor here
    ((torch.bfloat16, 1, 768, 3072), True),
    ((torch.bfloat16, 77, 768, 3072), True),    # ragged row count
    ((torch.float32, 4096, 768, 3072), False),
    ((torch.bfloat16, 128, 64, 128), False),
    ((torch.bfloat16, 128, 768, 3000), False),
    ((torch.bfloat16, 128, 1152, 4608), False),
    ((torch.bfloat16, 0, 768, 3072), False),
])
def test_ffn_block_supports(args, ok):
    assert tfb.supports(*args) is ok


def test_wrappers_raise_on_other_devices():
    x = torch.empty((1, 16, 128), dtype=torch.bfloat16, device="meta")
    w = torch.empty((384, 128), dtype=torch.bfloat16, device="meta")
    v = torch.empty((128,), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tab.attention_block(x, w, w[:, 0].contiguous(), w[:128], v, v, v,
                            torch.empty((1, 16), device="meta"), 2, 0.125, 1e-12)
    with pytest.raises(ValueError, match="unsupported device"):
        tfb.ffn_block(x[0], w, w[:, 0].contiguous(), w.t(), v, v, v, 1e-12)
    with pytest.raises(ValueError, match="act="):
        tfb.ffn_block(x[0], w, w[:, 0].contiguous(), w.t(), v, v, v, 1e-12, "relu")
