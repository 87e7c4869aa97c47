"""The port's int8 serving preset against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages. The
JAX int8 kernels run as tests/test_quant.py runs them on the CPU
(``interpret=True``); the port's wrappers take their plain versions because
the tensors lie on the CPU. Weights are handed to the port in nn.Linear
layout (the transpose of the JAX kernels' (in, out)) and quantized once by
the port's ``quantize_weight``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.core.config import load_config
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.ops import quant as jquant
from mdhs_tpu.ops import quant_kernel as jqk
from mdhs_tpu.train.trainer import bert_config_from
from mdhs_tpu_torch.core.convert import bert_state_dict_from_jax
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.ops import quant as tquant
from mdhs_tpu_torch.ops import quant_kernel as tqk
from mdhs_tpu_torch.presets import MIBF_HAM_SERVING

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
LN_EPS = 1e-12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _tie_matrix(rng, rows, cols):
    """Rows whose absmax is 127 * 2**e, so the scale is exactly 2**e and
    x / scale lands on .5 for the entries set to (k + 0.5) * 2**e."""
    e = rng.integers(-3, 4, rows).astype(np.float32)
    x = rng.uniform(-100, 100, (rows, cols)).astype(np.float32)
    half = rng.integers(-126, 126, (rows, cols)).astype(np.float32) + 0.5
    ties = rng.random((rows, cols)) < 0.5
    x = np.where(ties, half, x) * (2.0 ** e)[:, None]
    x[:, 0] = 127.0 * 2.0 ** e  # the absmax
    return x.astype(np.float32)


def _inputs(kind, seed, rows=24, cols=40):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return _tie_matrix(rng, rows, cols)
    return (rng.standard_normal((rows, cols)) * rng.uniform(0.01, 3.0, (rows, 1))).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_quantize_weight_is_bit_exact_with_jax(kind):
    w = _inputs(kind, seed=1)  # (N, K) in nn.Linear layout: a channel is a row
    ref_q, ref_s = jquant.quantize_weight(jnp.asarray(w.T))
    q, s = tquant.quantize_weight(_t(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    if kind == "ties":  # half to even, never half away from zero
        half = np.abs(np.abs(w / s.numpy()[:, None]) % 1.0 - 0.5) < 1e-6
        assert half.sum() > 100
        assert (q.numpy()[half] % 2 == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_quantize_rows_is_bit_exact_with_jax(kind, dtype):
    x = _inputs(kind, seed=2)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref_q, ref_s = jquant.quantize_rows(jx)
    q, s = tquant.quantize_rows(torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_kernel_row_quantization_is_bit_exact_with_jax(kind):
    """The kernels' recipe multiplies by float32(1/127) (quant_kernel.py:49-55);
    it can differ from quantize_rows by one ulp of the scale."""
    x = _inputs(kind, seed=3)
    ref_q, ref_s = jqk._rowquant_f32(jnp.asarray(x))
    q, s = tqk._rowquant(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_dense_matches_jax(with_bias):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)  # JAX (K, N)
    b = rng.normal(size=(8,)).astype(np.float32) if with_bias else None
    ref = jquant.int8_dense(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                            out_dtype=jnp.float32)
    out = tquant.int8_dense(_t(x), _t(w.T), None if b is None else _t(b), out_dtype=torch.float32)
    assert out.shape == (2, 6, 8) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)  # tests/test_quant.py:36


def test_int_matmul_is_exact_past_float32():
    """127 * 127 * 3072 > 2**24: a float32 product would round, int32 does not."""
    a = np.full((3, 3072), 127, np.int8)
    a[1] = -127
    w = np.full((5, 3072), 127, np.int8)
    w[2, :7] = 1
    out = tquant.int_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


# ---------------------------------------------------------------------------
# int8 sublayers: the port's plain versions against the JAX kernels in
# interpret mode, at tests/test_quant.py's shapes and bound (0.01 * max|out|)
# ---------------------------------------------------------------------------

def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _to_torch_bf16(a):
    return torch.tensor(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


def _within(out, ref, frac=0.01):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() < frac * scale, (np.abs(out - ref).max(), scale)


@pytest.fixture(scope="module")
def ffn_case():
    rng = np.random.default_rng(0)
    N, H, Di = 512, 256, 1024
    x = _bf16(rng.normal(size=(N, H)))
    p = dict(w1=rng.normal(size=(H, Di)) * 0.05, b1=rng.normal(size=(Di,)) * 0.1,
             w2=rng.normal(size=(Di, H)) * 0.05, b2=rng.normal(size=(H,)) * 0.1,
             g=rng.normal(size=(H,)) * 0.2 + 1.0, be=rng.normal(size=(H,)) * 0.1)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return x, p


@pytest.mark.parametrize("entry", ["reference", "wrapper"])
@pytest.mark.parametrize("act", ["erf", "tanh"])
def test_int8_ffn_block_matches_jax_kernel(ffn_case, act, entry):
    x, p = ffn_case
    jargs = (x, *(jnp.asarray(p[k]) for k in ("w1", "b1", "w2", "b2", "g", "be")))
    ref_k = jqk.int8_ffn_block(*jargs, LN_EPS, act, interpret=True)
    ref_r = jqk.int8_ffn_block_reference(*jargs, LN_EPS, act)
    w1, s1 = tquant.quantize_weight(_t(p["w1"].T))
    w2, s2 = tquant.quantize_weight(_t(p["w2"].T))
    fn = tqk.int8_ffn_block_reference if entry == "reference" else tqk.int8_ffn_block
    launches = tqk.int8_ffn_block.launches
    out = fn(_to_torch_bf16(x), w1, s1, _t(p["b1"]), w2, s2, _t(p["b2"]), _t(p["g"]), _t(p["be"]),
             LN_EPS, act)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert tqk.int8_ffn_block.launches == launches  # a CPU tensor takes the plain version
    _within(out.float().numpy(), ref_k)
    _within(out.float().numpy(), ref_r)


@pytest.mark.parametrize("cols", [64, 128, 256])
@pytest.mark.parametrize("Di", [384, 3072])
@pytest.mark.parametrize("N", [1, 37, 300])
def test_ffn_row_scale_from_tile_partials_is_jax_bit_for_bit(N, Di, cols):
    """The FFN kernel's two-pass staging (csrc/int8_ffn_block.cu): pass A's row
    maxima over each tile of columns, then their maximum, give _rowquant_f32's
    scale of the whole row bit for bit. Di 384 at 256 columns leaves a ragged
    last tile; every seventh row lies under the 1e-8 floor."""
    rng = np.random.default_rng(N + Di + cols)
    h = (rng.standard_normal((N, Di)) * rng.uniform(0.01, 3.0, (N, 1))).astype(np.float32)
    h[::7] *= 1e-9
    part = tqk.tile_absmax(_t(h), cols)
    assert part.shape == (N, -(-Di // cols))
    _, ref_s = jqk._rowquant_f32(jnp.asarray(h))
    np.testing.assert_array_equal(tqk.scale_from_partials(part).numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("entry", ["reference", "wrapper"])
def test_int8_attention_block_matches_jax_kernel(entry):
    rng = np.random.default_rng(0)
    B, L, HD, heads = 3, 128, 256, 4
    x = _bf16(rng.normal(size=(B, L, HD)))
    p = dict(wqkv=rng.normal(size=(HD, 3 * HD)) * 0.05, bqkv=rng.normal(size=(3 * HD,)) * 0.1,
             wo=rng.normal(size=(HD, HD)) * 0.05, bo=rng.normal(size=(HD,)) * 0.1,
             g=rng.normal(size=(HD,)) * 0.2 + 1.0, be=rng.normal(size=(HD,)) * 0.1)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    bias = np.where(rng.random((B, L)) > 0.2, 0.0, -1e9).astype(np.float32)
    sm = (HD // heads) ** -0.5
    jargs = (x, *(jnp.asarray(p[k]) for k in ("wqkv", "bqkv", "wo", "bo", "g", "be")), jnp.asarray(bias))
    ref_k = jqk.int8_attention_block(*jargs, heads, sm, LN_EPS, interpret=True)
    ref_r = jqk.int8_attention_block_reference(*jargs, heads, sm, LN_EPS)
    wqkv, sqkv = tquant.quantize_weight(_t(p["wqkv"].T))
    wo, so = tquant.quantize_weight(_t(p["wo"].T))
    fn = tqk.int8_attention_block_reference if entry == "reference" else tqk.int8_attention_block
    launches = tqk.int8_attention_block.launches
    out = fn(_to_torch_bf16(x), wqkv, sqkv, _t(p["bqkv"]), wo, so, _t(p["bo"]), _t(p["g"]), _t(p["be"]),
             _t(bias), heads, sm, LN_EPS)
    assert out.dtype == torch.bfloat16 and out.shape == (B, L, HD)
    assert tqk.int8_attention_block.launches == launches
    _within(out.float().numpy(), ref_k)
    _within(out.float().numpy(), ref_r)


def _attn_case(rng, B, L, HD, dtype):
    """The port's int8 attention arguments, made with numpy: x, nn.Linear-layout
    weights quantized by the port, float32 biases and LayerNorm, a key bias
    padding the last keys of row 0."""
    x = torch.tensor(rng.normal(size=(B, L, HD)).astype(np.float32)).to(dtype)
    wqkv, sqkv = tquant.quantize_weight(_t(rng.normal(size=(3 * HD, HD)) * 0.05))
    wo, so = tquant.quantize_weight(_t(rng.normal(size=(HD, HD)) * 0.05))
    bias = np.zeros((B, L), np.float32)
    bias[0, L - 3:] = -1e9
    return (x, wqkv, sqkv, _t(rng.normal(size=(3 * HD,)) * 0.1), wo, so, _t(rng.normal(size=(HD,)) * 0.1),
            _t(rng.normal(size=(HD,)) * 0.2 + 1.0), _t(rng.normal(size=(HD,)) * 0.1), _t(bias))


# The kernel runs the int8 core on fused_attention's mainloop over the thirds of
# qkv: the plain versions of the two compute the same function, bit for bit.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, L, HD, heads", [(2, 128, 256, 4), (3, 37, 128, 2)])
def test_int8_attention_core_is_fused_attentions_plain_version(dtype, B, L, HD, heads):
    from mdhs_tpu_torch.ops.fused_attention import attention_reference

    args = _attn_case(np.random.default_rng(L), B, L, HD, dtype)
    sm = (HD // heads) ** -0.5
    _, _, qkv, ctx, _, _, out = tqk.int8_attention_stages_reference(*args, heads, sm, LN_EPS)
    q, k, v = qkv.reshape(B, L, 3 * HD).split(HD, dim=-1)  # column windows of the same qkv
    ref = attention_reference(q, k, v, args[-1], heads, sm)
    assert ctx.dtype == dtype and torch.equal(ctx, ref.reshape(B * L, HD))
    assert torch.equal(out, tqk.int8_attention_block_reference(*args, heads, sm, LN_EPS))


# The QKV stage is the plain version's float32 (float(acc) * sx) * sqkv + bqkv, each
# step rounded on its own (the kernel's epilogue writes it with __fmul_rn / __fadd_rn),
# then rounded to bf16; x's row quantization is the JAX kernel's _rowquant_f32.
@pytest.mark.parametrize("B, L, HD", [(2, 64, 256), (1, 30, 128)])
def test_int8_qkv_stage_is_the_dequant_plus_bias_in_order(B, L, HD):
    rng = np.random.default_rng(HD + L)
    args = _attn_case(rng, B, L, HD, torch.bfloat16)
    x, wqkv, sqkv, bqkv = args[:4]
    x_i8, sx, qkv, *_ = tqk.int8_attention_stages_reference(*args, 2, 0.125, LN_EPS)
    ref_q, ref_s = jqk._rowquant_f32(jnp.asarray(x.float().reshape(B * L, HD).numpy()))
    np.testing.assert_array_equal(x_i8.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(ref_s)[:, 0])
    acc = (x_i8.numpy().astype(np.int64) @ wqkv.numpy().astype(np.int64).T).astype(np.float32)  # exact sums
    f32 = np.float32
    v = np.add(np.multiply(np.multiply(acc, sx.numpy()[:, None], dtype=f32), sqkv.numpy()[None, :], dtype=f32),
               bqkv.numpy()[None, :], dtype=f32)
    assert qkv.dtype == torch.bfloat16 and qkv.shape == (B * L, 3 * HD)
    assert torch.equal(qkv, torch.from_numpy(v).to(torch.bfloat16))


@pytest.mark.parametrize("args, ok", [
    ((torch.bfloat16, 128, 768, 12), True),   # the preset at seq 128
    ((torch.bfloat16, 256, 768, 12), True),   # the preset's own seq 256: the TPU gate rejected it
    ((torch.bfloat16, 100, 768, 12), True),   # ragged L: the attention core masks it
    ((torch.bfloat16, 1, 768, 12), True),
    ((torch.bfloat16, 320, 768, 12), True),
    ((torch.bfloat16, 384, 768, 12), True),   # the core streams its keys: fused_attention's 1 <= L <= 512
    ((torch.bfloat16, 512, 768, 12), True),
    ((torch.bfloat16, 513, 768, 12), False),
    ((torch.bfloat16, 128, 1024, 8), True),   # the widest LayerNorm cluster, 8 blocks; head_dim 128
    ((torch.bfloat16, 128, 1152, 12), False),  # wider than the LayerNorm cluster
    ((torch.bfloat16, 128, 1088, 8), False),  # head_dim 136, past the core's two 64-column chunks
    ((torch.float32, 128, 768, 12), False),
    ((torch.bfloat16, 128, 64, 4), False),    # hidden not a multiple of 128
    ((torch.bfloat16, 128, 384, 32), False),  # head_dim 12: not a multiple of 8
])
def test_int8_attention_supports(args, ok):
    assert tqk.attn_supports(*args) is ok


@pytest.mark.parametrize("args, ok", [
    ((torch.bfloat16, 512 * 128, 768, 3072), True),  # batch 512 x seq 128
    ((torch.bfloat16, 128, 768, 3072), True),        # batch 1: no n_rows >= 1024 floor
    ((torch.bfloat16, 77, 768, 3072), True),         # no n_rows % 256 condition
    ((torch.bfloat16, 0, 768, 3072), False),
    ((torch.float32, 4096, 768, 3072), False),
    ((torch.bfloat16, 4096, 768, 3000), False),
    ((torch.bfloat16, 4096, 1152, 4608), False),     # wider than the row-LayerNorm block
])
def test_int8_ffn_supports(args, ok):
    assert tqk.supports(*args) is ok


def test_int8_wrappers_raise_on_other_devices():
    x = torch.empty((1, 16, 128), dtype=torch.bfloat16, device="meta")
    w = torch.empty((384, 128), dtype=torch.int8, device="meta")
    s = torch.empty((384,), dtype=torch.float32, device="meta")
    v = torch.empty((128,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tqk.int8_attention_block(x, w, s, s, w[:128], v, v, v, v, torch.empty((1, 16), device="meta"),
                                 2, 0.125, 1e-12)
    with pytest.raises(ValueError, match="unsupported device"):
        tqk.int8_ffn_block(x[0], w, s, s, w.t(), v, v, v, v, 1e-12)
    with pytest.raises(ValueError, match="act="):
        tqk.int8_ffn_block(x[0], w, s, s, w.t(), v, v, v, v, 1e-12, "relu")


# ---------------------------------------------------------------------------
# BertModel(quantize="int8")
# ---------------------------------------------------------------------------

BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0, quantize="int8")


def _bert_inputs():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (3, 20)).astype(np.int64)
    mask = np.ones((3, 20), np.int64)
    mask[1, 13:] = 0
    mask[2, 4:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def int8_pair():
    jmodel = jbert.BertModel(jbert.BertConfig(**BERT), dtype=jnp.float32)
    ids, mask = _bert_inputs()
    var = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    rng = np.random.default_rng(3)
    # move every bias and LayerNorm scale off its identity init
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float32) + (
            rng.uniform(-0.1, 0.1, a.shape).astype(np.float32) if path[-1].key in ("bias", "scale") else 0
        ),
        var["params"],
    )
    model = tbert.BertModel(tbert.BertConfig(**BERT)).eval()
    model.load_state_dict(bert_state_dict_from_jax(params), strict=True)
    return jmodel, params, model


def test_bert_int8_every_hidden_state_matches_jax(int8_pair):
    """Both run the int8_dense composite in float32. Tolerance 1e-5: the
    two packages round the same values in the same order up to float32 sums
    in another order; a sum 1 ulp apart flips an int8 value only where it lies
    within 1 ulp of a .5 tie, which these inputs do not reach."""
    jmodel, params, model = int8_pair
    ids, mask = _bert_inputs()
    ref_last, ref_all = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        last, hidden = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(hidden) == len(ref_all) == 3
    for i, (h, r) in enumerate(zip(hidden, ref_all)):
        np.testing.assert_allclose(h.numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=f"hidden {i}")
    # and the int8 path is not the exact path
    exact = jmodel.clone(cfg=jbert.BertConfig(**{**BERT, "quantize": "none"}))
    ref_exact = exact.apply({"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))[0]
    assert np.abs(last.numpy() - np.asarray(ref_exact)).max() > 1e-4


def test_bert_int8_kernel_plumbing_matches_composite(int8_pair):
    """The arguments BertLayer hands the int8 kernels (packed and quantized
    Wqkv, float32 biases and LayerNorm, the (B, L) bias) are right: on CPU
    tensors the wrappers take their plain versions, which must agree with the
    composite. In float32 the two differ in the row scale (times
    float32(1/127) against / 127, at most one ulp apart), which moves an int8
    value by one step only where x / scale lies within an ulp of a .5 tie;
    no value here does, so the bound is float32 rounding, 1e-5."""
    _, _, model = int8_pair
    ids, mask = _bert_inputs()
    with torch.no_grad():
        _, hidden = model(torch.from_numpy(ids), torch.from_numpy(mask))
        bias = (1.0 - torch.from_numpy(mask)[:, None, None, :].float()) * -1e9
        for layer, h in zip(model.encoder.layer, hidden[:-1]):
            w = layer.int8_weights()
            a_mod = layer.int8_attention_sublayer(h, bias, w, kernel=False)
            a_ker = layer.int8_attention_sublayer(h, bias, w, kernel=True)
            np.testing.assert_allclose(a_ker.numpy(), a_mod.numpy(), atol=1e-5, rtol=0)
            f_mod = layer.int8_ffn_sublayer(a_mod, w, kernel=False)
            f_ker = layer.int8_ffn_sublayer(a_mod, w, kernel=True)
            np.testing.assert_allclose(f_ker.numpy(), f_mod.numpy(), atol=1e-5, rtol=0)


def test_bert_int8_is_ignored_in_training(int8_pair):
    _, params, model = int8_pair
    exact = tbert.BertModel(tbert.BertConfig(**{**BERT, "quantize": "none"}))
    exact.load_state_dict(model.state_dict(), strict=True)
    ids, mask = map(torch.from_numpy, _bert_inputs())
    outs = []
    for m in (model, exact):
        m.train()
        torch.manual_seed(7)  # dropout is 0 here; the seed keeps the two calls alike regardless
        with torch.no_grad():
            outs.append(m(ids, mask)[0])
        m.eval()
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


def test_bert_int8_state_dict_keys_are_the_exact_paths():
    a = tbert.BertModel(tbert.BertConfig.tiny())
    b = tbert.BertModel(dataclasses.replace(tbert.BertConfig.tiny(), quantize="int8")).eval()
    ids = torch.zeros((2, 8), dtype=torch.int64)
    with torch.no_grad():
        b(ids)  # the int8 weights now exist; they are no part of the state_dict
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    assert all(sa[k].shape == sb[k].shape and sa[k].dtype == sb[k].dtype for k in sa)


@pytest.mark.parametrize("assign", [False, True])
def test_bert_int8_weights_follow_load_state_dict(assign):
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), quantize="int8")
    gen = torch.Generator().manual_seed(0)
    model = init_parameters(tbert.BertModel(cfg), gen).eval()
    other = init_parameters(tbert.BertModel(cfg), gen).eval()
    ids = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    with torch.inference_mode():
        before = model(ids)[0]
        model.load_state_dict(other.state_dict(), assign=assign)
        after = model(ids)[0]
        want = other(ids)[0]
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, want, atol=0, rtol=0)


def test_bert_int8_weights_follow_in_place_updates():
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), quantize="int8")
    gen = torch.Generator().manual_seed(1)
    model = init_parameters(tbert.BertModel(cfg), gen).eval()
    ids = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    with torch.no_grad():
        before = model(ids)[0]
        init_parameters(model, gen)  # new values in the same storage
        after = model(ids)[0]
        fresh = tbert.BertModel(cfg).eval()
        fresh.load_state_dict(model.state_dict())
        want = fresh(ids)[0]
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, want, atol=0, rtol=0)


def test_bert_int8_runs_when_built_in_inference_mode():
    """Parameters made under inference_mode have no version counter."""
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), quantize="int8")
    ids = torch.zeros((2, 8), dtype=torch.int64)
    with torch.inference_mode():
        model = tbert.BertModel(cfg).eval()
        out = model(ids)[0]
    assert out.shape == (2, 8, cfg.hidden_size) and torch.isfinite(out).all()


def test_bert_int8_scales_stay_float32_under_a_dtype_cast():
    model = tbert.BertModel(dataclasses.replace(tbert.BertConfig.tiny(), quantize="int8")).eval()
    ids = torch.zeros((2, 8), dtype=torch.int64)
    with torch.no_grad():
        model(ids)
        model.to(torch.bfloat16)
        out = model(ids)[0]
    w = model.encoder.layer[0].int8_weights()
    assert out.dtype == torch.bfloat16
    assert w.wqkv.dtype == torch.int8 and w.w2.dtype == torch.int8
    assert all(t.dtype == torch.float32 for t in (w.sqkv, w.so, w.s1, w.s2, w.bqkv, w.g2))
    ref, _ = tquant.quantize_weight(model.encoder.layer[0].intermediate.dense.weight)
    torch.testing.assert_close(w.w1, ref, atol=0, rtol=0)  # made again from the bf16 weights


def test_serving_preset_is_the_yaml_resolution():
    cfg = load_config(REPO / "configs" / "serving" / "mibf_ham_serving.yml")
    want = bert_config_from(cfg, vocab_size=30522)  # bert-base-uncased's vocabulary
    assert dataclasses.asdict(MIBF_HAM_SERVING.bert) == dataclasses.asdict(want)
    assert MIBF_HAM_SERVING.batch_size == cfg.get("inference.batch_size") == 512
    assert MIBF_HAM_SERVING.seq_len == cfg.get("tokenizer.max_length") == 256
    assert MIBF_HAM_SERVING.num_labels == cfg.get("model.num_classes") == 7


# ---------------------------------------------------------------------------
# Which kernels a BertLayer takes (models/bert.py::_kernel_plan). The JAX int8
# branch (mdhs_tpu/models/bert.py:242-301) reads no attention_impl: it takes
# the int8 kernels wherever attn_supports / supports pass and the composite
# elsewhere, and never raises. The plan is pure Python, so the card's
# decisions are checked here with is_cuda=True.
# ---------------------------------------------------------------------------

# (B, L, hidden, heads, intermediate): a shape both int8 kernels take, and one whose
# head_dim 12 the int8 attention kernel and every bf16 attention kernel reject
PLAN_SHAPES = {"taken": (2, 128, 768, 12, 3072), "rejected": (2, 16, 384, 32, 512)}


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("impl", ["auto", "fused", "xla", "flash"])
def test_kernel_plan_takes_int8_kernels_under_every_impl(impl, quantize, shape):
    B, L, H, heads, inter = PLAN_SHAPES[shape]
    cfg = tbert.BertConfig(hidden_size=H, num_attention_heads=heads, intermediate_size=inter,
                           attention_impl=impl, quantize=quantize)

    def plan(**kw):
        args = dict(training=False, dtype=torch.bfloat16, is_cuda=True, B=B, L=L) | kw
        return tbert._kernel_plan(cfg, **args)

    int8_attn = tqk.attn_supports(torch.bfloat16, L, H, heads)
    int8_ffn = tqk.supports(torch.bfloat16, B * L, H, inter)
    assert (int8_attn, int8_ffn) == ((True, True) if shape == "taken" else (False, True))
    if quantize == "int8":
        assert plan() == (int8_attn, False, int8_ffn)  # the same under every impl; "fused" never raises
        with tbert.int8_composite():  # the explicit request for the composite
            assert plan() == (False, False, False)
        assert plan() == (int8_attn, False, int8_ffn)
    elif impl == "fused" and shape == "rejected":
        with pytest.raises(ValueError, match="attention_impl='fused'"):
            plan()
    elif impl in ("auto", "fused"):
        assert plan() == ((True, False, True) if shape == "taken" else (False, False, True))
    else:
        assert plan() == (False, False, False)
    # no kernel in training, off the card or outside bf16, whatever the config
    assert plan(training=True) == plan(is_cuda=False) == plan(dtype=torch.float32) == (False, False, False)
