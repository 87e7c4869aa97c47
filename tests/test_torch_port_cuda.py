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

from mdhs_tpu_torch.models.bert import BertConfig, BertModel
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
    plain = BertModel(dataclasses.replace(cfg, attention_impl="plain"), device=dev, dtype=torch.bfloat16).eval()
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


@pytest.mark.parametrize("B, L, HD, heads", [(2, 1, 64, 2), (3, 100, 128, 4), (2, 333, 768, 12),
                                             (2, 512, 768, 12), (1, 512, 512, 4)])
def test_fused_attention_kernel_matches_plain(dev, B, L, HD, heads):
    rng = np.random.default_rng(L)
    q, k, v = (_randn(rng, (B, L, HD), 1.0, dev) for _ in range(3))
    args = (q, k, v, _bias(rng, B, L, dev), heads, float(HD // heads) ** -0.5)
    n = fa.fused_attention.launches
    out = fa.fused_attention(*args)
    torch.cuda.synchronize()
    assert fa.fused_attention.launches == n + 1
    _close(out, fa.attention_reference(*args))


def _bert_pair(dev, **cfg):
    base = BertConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=512, max_position_embeddings=512)
    cfg = dataclasses.replace(base, **cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    fused = init_parameters(BertModel(cfg, device=dev, dtype=torch.bfloat16), g).eval()
    plain = BertModel(dataclasses.replace(cfg, attention_impl="plain"), device=dev, dtype=torch.bfloat16).eval()
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
        ref = plain(ids, mask)[0]  # the int8_dense composite
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, 0, 2, 2]
    # chip_smoke.py's bound for the int8 kernels against the int8 composite,
    # which rounds to bf16 before each re-quantization (INT8_ATOL there says why)
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
