"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
without one. The machine with the card has no JAX, so run this file without
the suite's conftest:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Shapes are small and ragged on purpose (odd row counts, L not a multiple of
16 or 64, head_dim 32 and 64); the full-width shapes run in chip_smoke.py.
Tolerances are the JAX kernels' own: max |d| <= 6e-2 and mean |d| < 5e-3 in
bf16 (tests/test_fused_attention.py:126-127) for the bf16 kernels, and max
|d| <= 0.01 * max |plain| (tests/test_quant.py:160) with mean |d| < 5e-3 for
the int8 kernels, where a float32 rounding apart can flip an int8 value.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mdhs_tpu_torch.models.bert import BertConfig, BertModel, int8_composite
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.ops import attention_block as ab
from mdhs_tpu_torch.ops import ffn_block as fb
from mdhs_tpu_torch.ops import fused_attention as fa
from mdhs_tpu_torch.ops import quant_kernel as qk
from mdhs_tpu_torch.ops.quant import int_matmul, quantize_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _close(out, ref):
    d = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert d.max().item() <= 6e-2 and d.mean().item() < 5e-3, (d.max().item(), d.mean().item())


def _randn(rng, shape, scale, dev):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.bfloat16, device=dev)


@pytest.mark.parametrize("B, L, HD, heads", [(2, 16, 128, 2), (3, 100, 128, 4), (2, 128, 768, 12), (1, 257, 256, 4)])
def test_attention_block_kernel_matches_plain(dev, B, L, HD, heads):
    rng = np.random.default_rng(L)
    x = _randn(rng, (B, L, HD), 1.0, dev)
    wqkv, bqkv = _randn(rng, (3 * HD, HD), 0.03, dev), _randn(rng, (3 * HD,), 0.01, dev)
    wo, bo = _randn(rng, (HD, HD), 0.03, dev), _randn(rng, (HD,), 0.01, dev)
    gamma = (1.0 + _randn(rng, (HD,), 0.1, dev)).contiguous()
    beta = _randn(rng, (HD,), 0.1, dev)
    mask = np.ones((B, L), np.float32)
    mask[:, L - L // 5:] = 0.0
    bias = torch.tensor((1.0 - mask) * -1e9, dtype=torch.float32, device=dev)
    args = (x, wqkv, bqkv, wo, bo, gamma, beta, bias, heads, float(HD // heads) ** -0.5, 1e-12)
    n = ab.attention_block.launches
    out = ab.attention_block(*args)
    torch.cuda.synchronize()
    assert ab.attention_block.launches == n + 1
    _close(out, ab.attention_block_reference(*args))


@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("N, H, Di", [(1, 128, 256), (37, 128, 384), (300, 768, 3072)])
def test_ffn_block_kernel_matches_plain(dev, N, H, Di, act):
    rng = np.random.default_rng(N)
    x = _randn(rng, (N, H), 1.0, dev)
    w1, b1 = _randn(rng, (Di, H), 0.03, dev), _randn(rng, (Di,), 0.01, dev)
    w2, b2 = _randn(rng, (H, Di), 0.03, dev), _randn(rng, (H,), 0.01, dev)
    gamma = (1.0 + _randn(rng, (H,), 0.1, dev)).contiguous()
    beta = _randn(rng, (H,), 0.1, dev)
    args = (x, w1, b1, w2, b2, gamma, beta, 1e-12, act)
    n = fb.ffn_block.launches
    out = fb.ffn_block(*args)
    torch.cuda.synchronize()
    assert fb.ffn_block.launches == n + 1
    _close(out, fb.ffn_block_reference(*args))


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros((2, 16, 128), dtype=torch.float32, device=dev)  # float32: not the kernel's
    w = torch.zeros((384, 128), dtype=torch.float32, device=dev)
    v = torch.zeros((128,), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        ab.attention_block(x, w, w[:, 0].contiguous(), w[:128].contiguous(), v, v, v,
                           torch.zeros((2, 16), device=dev), 2, 0.125, 1e-12)
    xb, vb = x[0].to(torch.bfloat16), v.to(torch.bfloat16)
    wb = w[:128].to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fb.ffn_block(xb, wb.t(), vb, wb, vb, vb, vb, 1e-12)


def test_bert_layers_use_the_kernels(dev):
    cfg = BertConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=512, max_position_embeddings=128)
    g = torch.Generator(device=dev).manual_seed(0)
    fused = init_parameters(BertModel(cfg, device=dev, dtype=torch.bfloat16), g).eval()
    plain = BertModel(dataclasses.replace(cfg, attention_impl="xla"), device=dev, dtype=torch.bfloat16).eval()
    plain.load_state_dict(fused.state_dict())
    ids = torch.randint(0, 512, (3, 40), generator=g, device=dev)
    mask = torch.ones((3, 40), dtype=torch.int64, device=dev)
    mask[1, 30:] = 0
    na, nf = ab.attention_block.launches, fb.ffn_block.launches
    with torch.inference_mode():
        out = fused(ids, mask)[0]
        ref = plain(ids, mask)[0]
    assert ab.attention_block.launches - na == 2 and fb.ffn_block.launches - nf == 2
    d = (out.float() - ref.float()).abs()
    assert d.max().item() < 0.15 and d.mean().item() < 0.01


def _close_int8(out, ref):
    d = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    bound = 0.01 * ref.float().abs().max().item()
    assert d.max().item() <= bound and d.mean().item() < 5e-3, (d.max().item(), bound, d.mean().item())


def _bias(rng, B, L, dev):
    mask = np.ones((B, L), np.float32)
    mask[:, L - L // 5:] = 0.0
    mask[0, 1::7] = 0.0
    return torch.tensor((1.0 - mask) * -1e9, dtype=torch.float32, device=dev)


def _f32(rng, shape, scale, dev, offset=0.0):
    return torch.tensor(offset + rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("M, K, N", [(3, 64, 8), (40, 768, 2304), (300, 3072, 768)])
def test_int_matmul_on_the_card_is_exact(dev, M, K, N):
    rng = np.random.default_rng(M)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (N, K)).astype(np.int8)
    out = int_matmul(torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev))
    np.testing.assert_array_equal(out.cpu().numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("N, H, Di", [(1, 128, 256), (37, 128, 384), (300, 768, 3072)])
def test_int8_ffn_block_kernel_matches_plain(dev, N, H, Di, act):
    rng = np.random.default_rng(N)
    x = _randn(rng, (N, H), 1.0, dev)
    w1, s1 = quantize_weight(_randn(rng, (Di, H), 0.03, dev))
    w2, s2 = quantize_weight(_randn(rng, (H, Di), 0.03, dev))
    args = (x, w1, s1, _f32(rng, (Di,), 0.01, dev), w2, s2, _f32(rng, (H,), 0.01, dev),
            _f32(rng, (H,), 0.1, dev, 1.0), _f32(rng, (H,), 0.1, dev), 1e-12, act)
    n = qk.int8_ffn_block.launches
    out = qk.int8_ffn_block(*args)
    torch.cuda.synchronize()
    assert qk.int8_ffn_block.launches == n + 1
    _close_int8(out, qk.int8_ffn_block_reference(*args))


@pytest.mark.parametrize("B, L, HD, heads", [(2, 16, 128, 2), (3, 100, 128, 4), (2, 128, 768, 12),
                                             (1, 256, 768, 12)])
def test_int8_attention_block_kernel_matches_plain(dev, B, L, HD, heads):
    rng = np.random.default_rng(L)
    x = _randn(rng, (B, L, HD), 1.0, dev)
    wqkv, sqkv = quantize_weight(_randn(rng, (3 * HD, HD), 0.03, dev))
    wo, so = quantize_weight(_randn(rng, (HD, HD), 0.03, dev))
    args = (x, wqkv, sqkv, _f32(rng, (3 * HD,), 0.01, dev), wo, so, _f32(rng, (HD,), 0.01, dev),
            _f32(rng, (HD,), 0.1, dev, 1.0), _f32(rng, (HD,), 0.1, dev), _bias(rng, B, L, dev),
            heads, float(HD // heads) ** -0.5, 1e-12)
    n = qk.int8_attention_block.launches
    out = qk.int8_attention_block(*args)
    torch.cuda.synchronize()
    assert qk.int8_attention_block.launches == n + 1
    _close_int8(out, qk.int8_attention_block_reference(*args))


# L past, inside and at the 128-key tile (1, 100, 333, 500, 512); head_dim 16, 32, 64, 128, and 40 and 72,
# which are not multiples of the 64-column chunk (the box also reads the next head's columns)
@pytest.mark.parametrize("B, L, HD, heads", [(2, 1, 64, 2), (3, 100, 128, 4), (2, 333, 768, 12),
                                             (2, 512, 768, 12), (1, 512, 512, 4), (2, 500, 768, 12),
                                             (3, 100, 320, 8), (2, 333, 120, 3), (2, 1, 256, 2),
                                             (2, 257, 384, 3), (2, 200, 288, 4)])
def test_fused_attention_kernel_matches_plain(dev, B, L, HD, heads):
    rng = np.random.default_rng(L)
    q, k, v = (_randn(rng, (B, L, HD), 1.0, dev) for _ in range(3))
    bias = _bias(rng, B, L, dev)
    bias[-1] = -1e9  # a row whose keys are all masked: a uniform softmax, as the plain version's
    args = (q, k, v, bias, heads, float(HD // heads) ** -0.5)
    n = fa.fused_attention.launches
    out = fa.fused_attention(*args)
    torch.cuda.synchronize()
    assert fa.fused_attention.launches == n + 1
    _close(out, fa.attention_reference(*args))
    assert torch.equal(fa.fused_attention(*args), out)  # a second launch gives the same bits


def _bert_pair(dev, **cfg):
    base = BertConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=512, max_position_embeddings=512)
    cfg = dataclasses.replace(base, **cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    fused = init_parameters(BertModel(cfg, device=dev, dtype=torch.bfloat16), g).eval()
    plain = BertModel(dataclasses.replace(cfg, attention_impl="xla"), device=dev, dtype=torch.bfloat16).eval()
    plain.load_state_dict(fused.state_dict())
    return fused, plain, g


def _counts():
    return (ab.attention_block.launches, fb.ffn_block.launches, fa.fused_attention.launches,
            qk.int8_attention_block.launches, qk.int8_ffn_block.launches)


@pytest.mark.parametrize("L", [40, 256])
def test_bert_int8_layers_use_the_int8_kernels(dev, L):
    fused, plain, g = _bert_pair(dev, quantize="int8", fast_math=True)
    ids = torch.randint(0, 512, (3, L), generator=g, device=dev)
    mask = torch.ones((3, L), dtype=torch.int64, device=dev)
    mask[1, L // 2:] = 0
    before = _counts()
    with torch.inference_mode():
        out = fused(ids, mask)[0]
        with int8_composite():
            ref = plain(ids, mask)[0]  # the int8_dense composite
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, 0, 2, 2]
    # chip_smoke.py's bound for the int8 kernels against the int8 composite,
    # which rounds to bf16 before each re-quantization (INT8_ATOL there says why)
    d = (out.float() - ref.float()).abs()
    assert d.max().item() <= 0.25 and d.mean().item() < 0.03


def test_bert_int8_takes_its_kernels_under_xla_and_the_composite_on_request(dev):
    """The JAX int8 branch reads no attention_impl: "xla" + int8 takes both int8
    kernels, 2 x layers launches; int8_composite() runs the composite, none."""
    model, _, g = _bert_pair(dev, quantize="int8", attention_impl="xla")
    ids = torch.randint(0, 512, (3, 64), generator=g, device=dev)
    mask = torch.ones((3, 64), dtype=torch.int64, device=dev)
    mask[2, 40:] = 0
    before = _counts()
    with torch.inference_mode():
        out = model(ids, mask)[0]
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, 0, 2, 2]
    before = _counts()
    with torch.inference_mode(), int8_composite():
        ref = model(ids, mask)[0]
    assert _counts() == before
    d = (out.float() - ref.float()).abs()
    assert d.max().item() <= 0.25 and d.mean().item() < 0.03


def test_bert_seq512_uses_fused_attention(dev):
    fused, plain, g = _bert_pair(dev)
    ids = torch.randint(0, 512, (2, 512), generator=g, device=dev)
    mask = torch.ones((2, 512), dtype=torch.int64, device=dev)
    mask[1, 300:] = 0
    before = _counts()
    with torch.inference_mode():
        out = fused(ids, mask)[0]
        ref = plain(ids, mask)[0]
    assert [a - b for a, b in zip(_counts(), before)] == [0, 2, 2, 0, 0]
    d = (out.float() - ref.float()).abs()
    assert d.max().item() < 0.15 and d.mean().item() < 0.01


def test_fused_impl_raises_where_no_kernel_takes_the_shape(dev):
    model = BertModel(BertConfig(vocab_size=64, hidden_size=384, num_hidden_layers=1, num_attention_heads=32,
                                 intermediate_size=512, max_position_embeddings=64, attention_impl="fused"),
                      device=dev, dtype=torch.bfloat16).eval()
    with pytest.raises(ValueError, match="attention_impl='fused'"), torch.inference_mode():
        model(torch.zeros((1, 16), dtype=torch.int64, device=dev))


# --------------------------------------------------------------------------- the training step's kernels
# shear_sublane: bit-exact against its plain version (two products and one
# sum, each rounded). bn_stats: float32 sums in another order than torch's
# reduction: rtol 1e-5 on mean and variance, with atol 1e-6 * E|x| on the
# mean and 1e-6 * E[x^2] on the variance (a mean near zero has no relative
# precision); its backward within 1e-5 of the largest gradient.
from mdhs_tpu_torch.models.norm import BatchNorm2d  # noqa: E402
from mdhs_tpu_torch.ops import augment as aug  # noqa: E402
from mdhs_tpu_torch.ops import bn_stats as bns  # noqa: E402
from mdhs_tpu_torch.ops import shear as sh  # noqa: E402


@pytest.mark.parametrize("B, C, W, L, pad", [(32, 3, 224, 224, 17), (32, 3, 224, 224, 31), (4, 3, 224, 224, 49),
                                             (4, 3, 224, 224, 82), (3, 2, 37, 45, 5), (1, 1, 1, 1, 1)])
def test_shear_kernel_is_bit_exact(dev, B, C, W, L, pad):
    rng = np.random.default_rng(W + L + pad)
    x = torch.zeros((B, C, W + 2 * pad, L), dtype=torch.float32)
    x[:, :, pad:pad + W] = torch.from_numpy(rng.random((B, C, W, L)).astype(np.float32))
    d = torch.from_numpy((rng.uniform(-1, 1, (B, L)) * (pad - 0.01)).astype(np.float32))
    x, d = x.to(dev), d.to(dev)
    n = sh.shear_sublane.launches
    out = sh.shear_sublane(x, d, pad)
    torch.cuda.synchronize()
    assert sh.shear_sublane.launches == n + 1
    assert torch.equal(out, sh.shear_reference(x, d, pad))
    assert torch.equal(out.cpu(), sh.shear_reference(x.cpu(), d.cpu(), pad))


def test_rotation_launches_three_shears(dev):
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.random((4, 64, 64, 3)).astype(np.float32))
    angles = torch.from_numpy(np.radians(rng.uniform(-15, 15, 4)).astype(np.float32))
    n = sh.shear_sublane.launches
    out = aug.rotate_3shear(imgs.to(dev), angles.to(dev), 15.0)
    assert sh.shear_sublane.launches == n + 3
    # tan / sin of float32 angles may differ by an ulp between the card and the CPU
    torch.testing.assert_close(out.cpu(), aug.rotate_3shear(imgs, angles, 15.0), atol=1e-5, rtol=0)


def _close_stats(got, want, x):
    (m, v), (mr, vr) = got, want
    xf = x.float()
    torch.testing.assert_close(m, mr, rtol=1e-5, atol=1e-6 * xf.abs().mean().item())
    torch.testing.assert_close(v, vr, rtol=1e-5, atol=1e-6 * xf.square().mean().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(32 * 56 * 56, 64), (32 * 7 * 7, 2048), (1000, 40), (129, 3), (1, 5)])
def test_bn_stats_kernel_matches_plain(dev, shape, dtype):
    rng = np.random.default_rng(shape[0] + shape[1])
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 5).astype(np.float32)).to(dev, dtype)
    n = bns.bn_stats.launches
    got = bns.bn_stats(x)
    torch.cuda.synchronize()
    assert bns.bn_stats.launches == n + 1
    assert got[0].dtype == got[1].dtype == torch.float32
    _close_stats(got, bns.bn_stats_reference(x), x)


def test_bn_stats_kernel_backward_matches_plain_autograd(dev):
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((16, 28, 28, 128)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal(128).astype(np.float32)).to(dev)
    grads = []
    for fn in (bns.bn_stats, bns.bn_stats_reference):
        x = x0.clone().requires_grad_()
        m, v = fn(x)
        (torch.sum(w * m) + torch.sum(torch.sqrt(v + 1e-5))).backward()
        grads.append(x.grad)
    scale = grads[1].abs().max().item()
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5 * scale, rtol=1e-4)


def test_batchnorm_switch_launches_bn_stats_in_training_only(dev):
    bn = BatchNorm2d(64, bn_stats_kernel=True, device=dev)
    ref = torch.nn.BatchNorm2d(64, device=dev)
    x = torch.randn(8, 64, 28, 28, device=dev, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    n = bns.bn_stats.launches
    y = bn(x)
    assert bns.bn_stats.launches == n + 1 and y.dtype == torch.bfloat16
    _close(y, ref(x))
    torch.testing.assert_close(bn.running_var, ref.running_var, atol=1e-4, rtol=1e-3)
    bn.eval()
    bn(x)
    assert bns.bn_stats.launches == n + 1


def test_training_kernel_wrappers_raise_instead_of_falling_back(dev):
    with pytest.raises(ValueError, match="unsupported"):
        sh.shear_sublane(torch.zeros((2, 3, 40, 16), device=dev, dtype=torch.bfloat16),
                         torch.zeros((2, 16), device=dev), 5)
    with pytest.raises(ValueError, match="contiguous"):
        sh.shear_sublane(torch.zeros((2, 3, 16, 40), device=dev).transpose(2, 3), torch.zeros((2, 16), device=dev), 5)
    with pytest.raises(ValueError, match="unsupported"):
        bns.bn_stats(torch.zeros((64, 32), device=dev, dtype=torch.float16))


def test_trainer_launches_the_shear_in_steps_and_the_sublayers_in_validation(dev):
    import dataclasses as dc

    from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer

    bert = BertConfig(vocab_size=512, num_hidden_layers=2, intermediate_size=512,  # MIBF's fusion is 768 wide
                      max_position_embeddings=128)
    preset = dc.replace(MIBF_HAM_TRAIN, bert=bert, batch_size=4, seq_len=40, canvas=72, image_size=64)
    trainer = Trainer(preset, device=dev)
    rng = np.random.default_rng(0)

    def batch(n_valid):
        return {"image": rng.integers(0, 256, (4, 72, 72, 3), dtype=np.uint8),
                "input_ids": rng.integers(0, 512, (4, 40)), "attention_mask": np.ones((4, 40), np.int64),
                "label": rng.integers(0, 7, 4), "n_valid": np.int32(n_valid)}

    before = _counts() + (sh.shear_sublane.launches,)
    m = trainer.train_step(batch(3))
    assert [a - b for a, b in zip(_counts() + (sh.shear_sublane.launches,), before)] == [0, 0, 0, 0, 0, 3]
    assert bool(torch.isfinite(m["loss"]))
    before = _counts()
    trainer.validate([batch(4), batch(2)])
    assert [a - b for a, b in zip(_counts(), before)] == [4, 4, 0, 0, 0]
    assert trainer.model.image_encoder.bn1.running_var.dtype == torch.float32


def test_trainer_validates_before_its_first_step(dev):
    """Staging buffers made inside validate's inference mode are written again by train steps."""
    import dataclasses as dc

    from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer

    bert = BertConfig(vocab_size=512, num_hidden_layers=1, intermediate_size=512, max_position_embeddings=128)
    trainer = Trainer(dc.replace(MIBF_HAM_TRAIN, bert=bert, batch_size=4, seq_len=40, canvas=72, image_size=64),
                      device=dev)
    rng = np.random.default_rng(1)
    batch = {"image": rng.integers(0, 256, (4, 72, 72, 3), dtype=np.uint8),
             "input_ids": rng.integers(0, 512, (4, 40)), "attention_mask": np.ones((4, 40), np.int64),
             "label": rng.integers(0, 7, 4)}
    for _ in range(2):  # both slots of the staging ring
        loss, _ = trainer.validate([batch])
        assert np.isfinite(loss)
    for _ in range(2):
        assert bool(torch.isfinite(trainer.train_step(batch)["loss"]))


# --------------------------------------------------------------------------- the baseline family's kernels
# selective_scan and kan_forward compute in float32: max |d| <= 1e-4 * max |plain|
# (float32 sums in another order and FMA contraction; the recurrence carries its
# rounding over L steps).
from mdhs_tpu_torch.models.baseline import BaselineConfig, MultimodalBaselineModel  # noqa: E402
from mdhs_tpu_torch.modules import mamba as mamba_mod  # noqa: E402
from mdhs_tpu_torch.modules import moe as moe_mod  # noqa: E402
from mdhs_tpu_torch.ops import kan_spline as ks  # noqa: E402
from mdhs_tpu_torch.ops import selective_scan as ss  # noqa: E402


def _close_f32(out, ref):
    assert out.dtype == torch.float32 and out.shape == ref.shape and torch.isfinite(out).all()
    d = (out - ref).abs().max().item()
    assert d <= 1e-4 * ref.abs().max().item(), (d, ref.abs().max().item())


def _scan_args(rng, B, L, D, N, dev):
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return (f(rng.standard_normal((B, L, D))), f(np.log1p(np.exp(rng.standard_normal((B, L, D))))),
            f(-np.exp(rng.standard_normal((D, N)))), f(rng.standard_normal((B, L, N))),
            f(rng.standard_normal((B, L, N))), f(rng.standard_normal(D)))


@pytest.mark.parametrize("B, L, D, N", [(64, 49, 512, 16), (3, 100, 72, 8), (5, 33, 130, 32), (4, 20, 64, 64),
                                        (2, 70, 512, 128), (1, 1, 1, 1)])
def test_selective_scan_kernel_matches_plain(dev, B, L, D, N):
    args = _scan_args(np.random.default_rng(L + N), B, L, D, N, dev)
    n = ss.selective_scan.launches
    out = ss.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == n + 1
    _close_f32(out, ss.selective_scan_reference(*args))


def _kan_args(rng, E, B, IN, OUT, dev, shared):
    from mdhs_tpu_torch.modules.kan import make_grid

    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    lead = () if E is None else (E,)
    x = f(rng.standard_normal(((B, IN) if shared or E is None else (E, B, IN))) * 0.7)
    grid = make_grid(IN, 5, 3, device=dev).expand(*lead, IN, 12).contiguous()
    return x, grid, f(rng.standard_normal(lead + (OUT, IN)) * 0.1), f(rng.standard_normal(lead + (OUT, IN, 8)) * 0.1)


@pytest.mark.parametrize("E, B, IN, OUT, shared", [(4, 64, 256, 1024, True), (4, 64, 1024, 7, False),
                                                   (None, 40, 64, 200, False), (None, 3, 5, 7, False),
                                                   (2, 33, 20, 70, False), (3, 1, 9, 1, True)])
def test_kan_forward_kernel_matches_plain(dev, E, B, IN, OUT, shared):
    args = _kan_args(np.random.default_rng(B + IN + OUT), E, B, IN, OUT, dev, shared)
    n = ks.kan_forward.launches
    out = ks.kan_forward(*args)
    torch.cuda.synchronize()
    assert ks.kan_forward.launches == n + 1
    _close_f32(out, ks.kan_forward_reference(*args))


def test_baseline_kernel_wrappers_raise_instead_of_falling_back(dev):
    args = _scan_args(np.random.default_rng(0), 2, 8, 16, 16, dev)
    with pytest.raises(ValueError, match="unsupported"):
        ss.selective_scan(args[0].to(torch.bfloat16), *args[1:])
    with pytest.raises(ValueError, match="unsupported"):
        ss.selective_scan(*args[:2], torch.zeros((16, 129), device=dev), *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        ss.selective_scan(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
    x, grid, bw, sw = _kan_args(np.random.default_rng(1), None, 4, 8, 5, dev, False)
    with pytest.raises(ValueError, match="unsupported"):
        ks.kan_forward(x.to(torch.bfloat16), grid, bw, sw)
    with pytest.raises(ValueError, match="unsupported"):
        ks.kan_forward(x, grid, bw, sw, spline_order=2)
    with pytest.raises(ValueError, match="contiguous"):
        ks.kan_forward(x, grid, bw.t().contiguous().t(), sw)


def test_baseline_models_launch_the_new_kernels(dev, monkeypatch):
    """float32 models, so the BERT sublayer kernels stay off: each forward
    launches selective_scan once (mamba) or kan_forward twice (the MoE bank's
    two layers), and matches the same weights with the op routed to its
    plain version."""
    bert = BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
                      intermediate_size=128, max_position_embeddings=128)
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.standard_normal((3, 3, 64, 64)), dtype=torch.float32, device=dev)
    ids = torch.tensor(rng.integers(0, 512, (3, 20)), device=dev)
    mask = torch.ones((3, 20), dtype=torch.int64, device=dev)
    mask[1, 12:] = 0
    for fusion, head, fn, per_forward in (("mamba", "mlp", ss.selective_scan, 1), ("multiscale", "moe", ks.kan_forward, 2)):
        cfg = BaselineConfig(hidden_dim=64, num_heads=8, text_feature_dim=64, fusion_type=fusion, classifier_type=head,
                             bert=bert)
        model = init_parameters(MultimodalBaselineModel(cfg, device=dev), torch.Generator(device=dev).manual_seed(0)).eval()
        if head == "moe":
            with torch.no_grad():
                model.classifier.moe.w_gate.normal_()
        before = _counts() + (ss.selective_scan.launches, ks.kan_forward.launches)
        with torch.inference_mode():
            out = model(img, ids, mask)
        launched = [a - b for a, b in zip(_counts() + (ss.selective_scan.launches, ks.kan_forward.launches), before)]
        want = [0, 0, 0, 0, 0, per_forward if fn is ss.selective_scan else 0, per_forward if fn is ks.kan_forward else 0]
        assert launched == want, (fusion, head, launched)
        plain = ss.selective_scan_reference if fn is ss.selective_scan else ks.kan_forward_reference
        with monkeypatch.context() as m:
            m.setattr(mamba_mod._ss if fn is ss.selective_scan else moe_mod._ks, fn.__name__, plain)
            with torch.inference_mode():
                ref = model(img, ids, mask)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- BERT's flash-attention kernels
# The forward within the bf16 bound above; dQ, dK and dV within max |d| <=
# 0.02 * max |plain| and mean |d| <= 2e-3 * max |plain| (bf16 p and ds are
# rounded relative to the kernel's own float32 scores, so a rounding apart
# moves a gradient by a bf16 step of its largest term).
from mdhs_tpu_torch.ops import flash_attention as fl  # noqa: E402

_FLASH_SHAPES = [(2, 128, 768, 12), (4, 512, 768, 12), (32, 256, 768, 12), (3, 200, 256, 8), (2, 384, 512, 4),
                 (1, 1, 64, 2)]


def _flash_args(B, L, HD, heads, dev):
    """q, k, v, seg with the rows the masking must get right: pads at the end,
    no pads, mostly pads, keys of the second segment only in the last tile."""
    rng = np.random.default_rng(B * L + HD)
    q, k, v = (_randn(rng, (B, L, HD), 1.0, dev) for _ in range(3))
    seg = np.ones((B, L), np.int32)
    seg[0, max(1, L - 5):] = 0
    if B > 2:
        seg[2, 3:] = 0
    if B > 3:
        seg[3, : max(0, L - 10)] = 0
    return q, k, v, torch.from_numpy(seg).to(dev), heads, float(HD // heads) ** -0.5


def _close_grad(out, ref):
    d = (out.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    assert torch.isfinite(out.float()).all() and out.dtype == ref.dtype
    assert d.max().item() <= 0.02 * scale and d.mean().item() <= 2e-3 * scale, (d.max().item(), d.mean().item(), scale)


# beside _FLASH_SHAPES: L 100, 333, 500, 200 and 130 (not multiples of the 128-row tile),
# head_dim 40 and 72 (not multiples of the 64-column chunk) and 128, four rows each, so
# that one row's second segment has keys only in the first tile and one only in the last
_FLASH_RAGGED = [(4, 100, 320, 8), (4, 333, 768, 12), (4, 500, 256, 2), (4, 200, 288, 4), (4, 130, 512, 4)]


@pytest.mark.parametrize("B, L, HD, heads", _FLASH_SHAPES + _FLASH_RAGGED)
def test_flash_forward_kernel_matches_plain(dev, B, L, HD, heads):
    args = _flash_args(B, L, HD, heads, dev)
    n = fl.flash_attention_forward.launches
    out, m, l = fl.flash_attention_forward(*args, save_stats=True)
    torch.cuda.synchronize()
    assert fl.flash_attention_forward.launches == n + 1
    ref, mr, lr = fl.flash_attention_reference(*args, save_stats=True)
    _close(out, ref)
    torch.testing.assert_close(m, mr, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(l, lr, atol=1e-3, rtol=1e-4)
    assert torch.equal(fl.flash_attention_forward(*args), out)  # without the statistics, the same o


def _flash_backward_args(B, L, HD, heads, dev):
    q, k, v, seg, heads, scale = _flash_args(B, L, HD, heads, dev)
    o, m, l = fl.flash_attention_reference(q, k, v, seg, heads, scale, save_stats=True)
    do = _randn(np.random.default_rng(L), (B, L, HD), 1.0, dev)
    return q, k, v, seg, o, m, l, do, heads, scale


@pytest.mark.parametrize("B, L, HD, heads", _FLASH_SHAPES + _FLASH_RAGGED)
def test_flash_backward_kernels_match_plain(dev, B, L, HD, heads):
    q, k, v, seg, o, m, l, do, heads, scale = _flash_backward_args(B, L, HD, heads, dev)
    n = (fl.flash_attention_bwd_dkv.launches, fl.flash_attention_bwd_dq.launches)
    dq, di = fl.flash_attention_bwd_dq(q, k, v, seg, o, m, l, do, heads, scale)
    dk, dv = fl.flash_attention_bwd_dkv(q, k, v, seg, m, l, do, di, heads, scale)
    torch.cuda.synchronize()
    assert (fl.flash_attention_bwd_dkv.launches, fl.flash_attention_bwd_dq.launches) == (n[0] + 1, n[1] + 1)
    dqr, dkr, dvr = fl.flash_attention_backward_reference(q, k, v, seg, o, m, l, do, heads, scale)
    for out, ref in ((dq, dqr), (dk, dkr), (dv, dvr)):
        _close_grad(out, ref)
    # no atomics: a second launch gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(fl.flash_attention_bwd_dq(q, k, v, seg, o, m, l, do, heads, scale),
                                                 (dq, di)))
    assert all(torch.equal(a, b) for a, b in zip(fl.flash_attention_bwd_dkv(q, k, v, seg, m, l, do, di, heads, scale),
                                                 (dk, dv)))


# The dQ kernel's di against attention_di. Each product of two bf16 values is exact in
# float32, so the two differ only in the order of D float32 additions: at most
# 2 D 2^-24 * sum |o * do| of the row (twice the recursive-summation bound), row by row.
@pytest.mark.parametrize("B, L, HD, heads", _FLASH_SHAPES + _FLASH_RAGGED)
def test_flash_dq_kernel_di_matches_attention_di(dev, B, L, HD, heads):
    q, k, v, seg, o, m, l, do, heads, scale = _flash_backward_args(B, L, HD, heads, dev)
    _, di = fl.flash_attention_bwd_dq(q, k, v, seg, o, m, l, do, heads, scale)
    ref = fl.attention_di(o, do, heads)
    bound = 2 * (HD // heads) * 2.0 ** -24 * fl.attention_di(o.abs(), do.abs(), heads)
    assert di.dtype == torch.float32 and di.shape == ref.shape == (B, heads, L)
    assert bool(((di - ref).abs() <= bound).all()), ((di - ref).abs().max().item(), bound.max().item())


def test_flash_autograd_function_matches_plain_autograd(dev):
    q, k, v, seg, heads, scale = _flash_args(4, 256, 768, 12, dev)
    do = _randn(np.random.default_rng(1), q.shape, 1.0, dev)
    grads = []
    n = [f.launches for f in (fl.flash_attention_forward, fl.flash_attention_bwd_dkv, fl.flash_attention_bwd_dq)]
    for fn in (fl.flash_attention, fl.flash_attention_reference):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, seg, heads, scale).backward(do)
        grads.append([t.grad for t in leaves])
    assert [f.launches for f in (fl.flash_attention_forward, fl.flash_attention_bwd_dkv,
                                 fl.flash_attention_bwd_dq)] == [x + 1 for x in n]
    for a, b in zip(*grads):
        _close_grad(a, b)


def test_flash_wrappers_raise_instead_of_falling_back(dev):
    q, k, v, seg, heads, scale = _flash_args(2, 128, 256, 4, dev)
    with pytest.raises(ValueError, match="unsupported"):
        fl.flash_attention_forward(q.float(), k.float(), v.float(), seg, heads, scale)
    with pytest.raises(ValueError, match="int32"):
        fl.flash_attention_forward(q, k, v, seg.long(), heads, scale)
    with pytest.raises(ValueError, match="contiguous"):
        fl.flash_attention_forward(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, seg, heads, scale)
    # float32 through the op BERT calls, with and without a gradient: an error, not the plain version
    n = _flash_counts()
    with pytest.raises(ValueError, match="unsupported dtype"):
        fl.flash_attention(q.float(), k.float(), v.float(), seg, heads, scale)
    with pytest.raises(ValueError, match="unsupported dtype"):
        fl.flash_attention(q.float().requires_grad_(), k.float(), v.float(), seg, heads, scale)
    assert _flash_counts() == n


def _flash_counts():
    return (fl.flash_attention_forward.launches, fl.flash_attention_bwd_dkv.launches, fl.flash_attention_bwd_dq.launches)


def test_bert_flash_uses_the_forward_kernel_and_no_sublayer_kernel(dev):
    fused, plain, g = _bert_pair(dev, attention_impl="flash")
    ids = torch.randint(0, 512, (2, 256), generator=g, device=dev)
    mask = torch.ones((2, 256), dtype=torch.int64, device=dev)
    mask[1, 100:] = 0
    before, fb_before = _counts(), _flash_counts()
    with torch.inference_mode():
        out = fused(ids, mask)[0]
        ref = plain(ids, mask)[0]
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, 0, 0, 0]
    assert [a - b for a, b in zip(_flash_counts(), fb_before)] == [2, 0, 0]
    d = (out.float() - ref.float())[mask.bool()].abs()  # pad positions differ by design
    assert d.max().item() < 0.15 and d.mean().item() < 0.01
    with torch.inference_mode():  # L % 128 != 0: the plain path, no launch
        fused(ids[:, :200], mask[:, :200])
    assert [a - b for a, b in zip(_flash_counts(), fb_before)] == [2, 0, 0]


def test_trainer_flash_preset_launches_the_three_kernels(dev):
    import dataclasses as dc

    from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer

    bert = BertConfig(vocab_size=512, num_hidden_layers=2, intermediate_size=512, max_position_embeddings=128,
                      attention_impl="flash", attention_dropout=0.0)
    trainer = Trainer(dc.replace(MIBF_HAM_TRAIN, bert=bert, batch_size=4, seq_len=128, canvas=72, image_size=64),
                      device=dev)
    rng = np.random.default_rng(2)
    mask = np.ones((4, 128), np.int64)
    mask[1, 60:] = 0
    batch = {"image": rng.integers(0, 256, (4, 72, 72, 3), dtype=np.uint8),
             "input_ids": rng.integers(0, 512, (4, 128)), "attention_mask": mask, "label": rng.integers(0, 7, 4)}
    before = _flash_counts()
    assert bool(torch.isfinite(trainer.train_step(batch)["loss"]))
    assert [a - b for a, b in zip(_flash_counts(), before)] == [2, 2, 2]
    before, sub = _flash_counts(), _counts()
    loss, _ = trainer.validate([batch])
    assert np.isfinite(loss)
    assert [a - b for a, b in zip(_flash_counts(), before)] == [2, 0, 0] and _counts() == sub


# --------------------------------------------------------------------------- no host sync inside a forward
def test_imagenet_normalization_makes_no_host_copy(dev):
    from mdhs_tpu_torch.ops.preprocess import eval_pipeline

    x = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8, device=dev)
    eval_pipeline(x, 32)  # the statistics are made once per device, here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eval_pipeline(x, 32)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_bert_fast_math_makes_no_host_copy(dev, impl):
    cfg = BertConfig(vocab_size=64, hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=256, max_position_embeddings=64, fast_math=True, attention_impl=impl)
    model = BertModel(cfg, device=dev, dtype=torch.bfloat16).eval()
    ids = torch.zeros((2, 16), dtype=torch.int64, device=dev)
    mask = torch.ones((2, 16), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        model(ids, mask)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model(ids, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")


# --------------------------------------------------------------------------- the attention ablation
# Each mode of attention_ablate against its plain version. The bias pads the last
# fifth of batch row 0's keys with -1e9 and gives the other rows a finite N(0, 1)
# bias, which nosmax adds in natural units. Each (batch, query) row is judged against
# its own max(1, max |plain|): the bf16 bound (max |d| <= 6e-2, mean < 5e-3) on
# |d| / that scale, since nosmax's outputs reach 1e10 in row 0 and about 10 elsewhere.
# nopv's outputs are probabilities rounded to bf16 as the plain version rounds them,
# so each is held to one bf16 ulp of its own: |d| <= 2^-7 |p| + 2^-24. aligned writes
# head_dim columns.
from mdhs_tpu_torch.diagnostics import attention_ablate as diag  # noqa: E402
from mdhs_tpu_torch.ops import attention_ablate as aa  # noqa: E402

# the TPU script's widths at batch 4; ragged L 100 and 200 (two key tiles: nopv keeps tile 0's
# P), head_dim 40 (not a multiple of the 64-column chunk) and 128 (two chunks); nopv needs L >= head_dim
_ABLATE_SHAPES = [(4, 128, 768, 12), (4, 100, 768, 12), (4, 128, 320, 8), (3, 200, 320, 8), (4, 128, 512, 4),
                  (2, 200, 512, 4)]


def _ablate_args(B, L, HD, heads, dev):
    rng = np.random.default_rng(L + HD)
    q, k, v = (_randn(rng, (B, L, HD), 1.0, dev) for _ in range(3))
    bias = rng.standard_normal((B, L)).astype(np.float32)
    bias[0] = 0.0
    bias[0, L - L // 5:] = -1e9
    return q, k, v, torch.tensor(bias, device=dev), heads, float(HD // heads) ** -0.5


def _close_rel(out, ref, mode):
    assert torch.isfinite(out.float()).all()
    o, r = out.float(), ref.float()
    if mode == "nopv":
        excess = (o - r).abs() - (2.0 ** -7 * r.abs() + 2.0 ** -24)
        assert excess.max().item() <= 0, excess.max().item()
        return
    d = (o - r).abs() / r.abs().amax(-1, keepdim=True).clamp_min(1.0)
    assert d.max().item() <= 6e-2 and d.mean().item() < 5e-3, (d.max().item(), d.mean().item())


@pytest.mark.parametrize("B, L, HD, heads", _ABLATE_SHAPES)
@pytest.mark.parametrize("mode", aa.MODES)
def test_attention_ablate_kernel_matches_plain(dev, mode, B, L, HD, heads):
    args = _ablate_args(B, L, HD, heads, dev)
    D = HD // heads
    n = aa.attention_ablate.launches
    out = aa.attention_ablate(*args, mode)
    torch.cuda.synchronize()
    assert aa.attention_ablate.launches == n + 1
    ref = aa.attention_ablate_reference(*args, mode)
    cols = slice(0, D) if mode == "aligned" else slice(None)
    _close_rel(out[..., cols], ref[..., cols], mode)
    assert torch.equal(aa.attention_ablate(*args, mode)[..., cols], out[..., cols])  # a second launch: the same bits


@pytest.mark.parametrize("B, L, HD, heads", _ABLATE_SHAPES)
def test_attention_ablate_full_is_fused_attention_and_aligned_is_head_0(dev, B, L, HD, heads):
    args = _ablate_args(B, L, HD, heads, dev)
    D = HD // heads
    full = aa.attention_ablate(*args, "full")
    assert torch.equal(full, fa.fused_attention(*args))
    assert torch.equal(aa.attention_ablate(*args, "aligned")[..., :D], full[..., :D])


def test_attention_ablate_raises_instead_of_falling_back(dev):
    q, k, v, bias, heads, scale = _ablate_args(2, 128, 768, 12, dev)
    n = aa.attention_ablate.launches
    with pytest.raises(ValueError, match="unsupported"):
        aa.attention_ablate(q.float(), k.float(), v.float(), bias, heads, scale, "full")
    with pytest.raises(ValueError, match="unsupported mode=nopv"):
        aa.attention_ablate(q[:, :32].contiguous(), k[:, :32].contiguous(), v[:, :32].contiguous(), bias[:, :32],
                            heads, scale, "nopv")
    with pytest.raises(ValueError, match="unknown mode"):
        aa.attention_ablate(q, k, v, bias, heads, scale, "nosoftmax")
    with pytest.raises(ValueError, match="float32"):
        aa.attention_ablate(q, k, v, bias.to(torch.bfloat16), heads, scale, "nomax")
    assert aa.attention_ablate.launches == n


@pytest.mark.parametrize("mode", aa.MODES)
def test_attention_ablate_launch_replays_in_a_cuda_graph(dev, mode):
    args = _ablate_args(4, 128, 768, 12, dev)
    eager = aa.attention_ablate(*args, mode)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        aa.attention_ablate(*args, mode)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = aa.attention_ablate(*args, mode)
    graph.replay()
    torch.cuda.synchronize()
    cols = slice(0, 64) if mode == "aligned" else slice(None)
    assert torch.equal(out[..., cols], eager[..., cols])


def test_ablation_chain_replays_its_graph(dev):
    """The diagnostic's chain (a CUDA graph of K_STEPS launches and sums) gives
    the eager chain's value, launches once a step at capture and none at replay,
    and refuses tensors other than those it was captured on."""
    q, k, v, bias, heads, _ = _ablate_args(8, 128, 768, 12, dev)
    bias = torch.zeros_like(bias)
    chain = diag.build("full", dev, 8, 128, 12, 64)
    n = aa.attention_ablate.launches
    first = chain(q, k, v, bias)
    assert aa.attention_ablate.launches == n + 2 * chain.steps  # the warm-up and the capture
    again = chain(q, k, v, bias)
    assert aa.attention_ablate.launches == n + 2 * chain.steps
    assert torch.equal(first, again) and torch.equal(first, chain.eager(q, k, v, bias))
    with pytest.raises(ValueError, match="captured on other tensors"):
        chain(q.clone(), k, v, bias)
