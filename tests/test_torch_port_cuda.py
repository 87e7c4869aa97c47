"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
without one. The machine with the card has no JAX, so run this file without
the suite's conftest:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Shapes are small and ragged on purpose (odd row counts, L not a multiple of
16 or 64, head_dim 32 and 64); the full-width shapes run in chip_smoke.py,
and the int8 FFN's also here, with its scratch and its peak allocation, and
the bf16 sublayers' at BERT-base widths on both of their plans (split K and
unsplit), each product alone against a float32 matmul.
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
from mdhs_tpu_torch.ops import _library
from mdhs_tpu_torch.ops import attention_block as ab
from mdhs_tpu_torch.ops import bf16_gemm as bg
from mdhs_tpu_torch.ops import ffn_block as fb
from mdhs_tpu_torch.ops import flash_attention as fl
from mdhs_tpu_torch.ops import fused_attention as fa
from mdhs_tpu_torch.ops import kan_spline as ks
from mdhs_tpu_torch.ops import quant_kernel as qk
from mdhs_tpu_torch.ops import selective_scan as ss
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


# --- the torch.ops.mdhs custom ops: small inputs inside every kernel's gate (bf16 for the attention
# and FFN sublayers and cores, float32 for the scan and the KAN layer; a padded key tail and a
# second segment where the op masks), each op's plain version and the wrapper whose ``launches``
# its CUDA implementation counts. test_torch_port_export.py runs the same ops on the CPU.
OPS = tuple(_library.OPS)

# each op's plain version and the public wrapper whose ``launches`` its CUDA implementation counts
PLAIN = {"attention_block": ab.attention_block_reference, "ffn_block": fb.ffn_block_reference,
         "fused_attention": fa.attention_reference,
         "flash_attention_forward": lambda *a: fl.flash_attention_reference(*a[:6], save_stats=a[6]),
         "int8_ffn_block": qk.int8_ffn_block_reference, "int8_attention_block": qk.int8_attention_block_reference,
         "selective_scan": ss.selective_scan_reference, "kan_forward": ks.kan_forward_reference}
WRAPPER = {"attention_block": ab.attention_block, "ffn_block": fb.ffn_block, "fused_attention": fa.fused_attention,
           "flash_attention_forward": fl.flash_attention_forward, "int8_ffn_block": qk.int8_ffn_block,
           "int8_attention_block": qk.int8_attention_block, "selective_scan": ss.selective_scan,
           "kan_forward": ks.kan_forward}


def op_args(name: str, device, seed: int = 0) -> tuple:
    """The op's arguments, made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        return torch.tensor(offset + rng.standard_normal(shape) * scale, dtype=dtype, device=device)

    def i8(shape):
        return torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8, device=device)

    f32 = torch.float32
    B, L, HD, heads, Di = 2, 24, 128, 2, 256
    bias = torch.zeros((B, L), dtype=f32, device=device)
    bias[1, L - 5:] = -1e9
    if name == "attention_block":
        return (t((B, L, HD)), t((3 * HD, HD), 0.03), t((3 * HD,), 0.01), t((HD, HD), 0.03), t((HD,), 0.01),
                t((HD,), 0.1, offset=1.0), t((HD,), 0.1), bias, heads, 0.125, 1e-12)
    if name == "ffn_block":
        return (t((37, HD)), t((Di, HD), 0.03), t((Di,), 0.01), t((HD, Di), 0.03), t((HD,), 0.01),
                t((HD,), 0.1, offset=1.0), t((HD,), 0.1), 1e-12, "erf")
    if name == "fused_attention":
        return (t((B, L, HD)), t((B, L, HD)), t((B, L, HD)), bias, heads, 0.125)
    if name == "flash_attention_forward":
        seg = torch.ones((B, L), dtype=torch.int32, device=device)
        seg[1, L - 5:] = 0
        return (t((B, L, HD)), t((B, L, HD)), t((B, L, HD)), seg, heads, 0.125, True)
    if name == "int8_ffn_block":
        return (t((37, HD)), i8((Di, HD)), t((Di,), 1e-3, f32, 2e-3), t((Di,), 0.01, f32), i8((HD, Di)),
                t((HD,), 1e-3, f32, 2e-3), t((HD,), 0.01, f32), t((HD,), 0.1, f32, 1.0), t((HD,), 0.1, f32),
                1e-12, "tanh")
    if name == "int8_attention_block":
        return (t((B, L, HD)), i8((3 * HD, HD)), t((3 * HD,), 1e-4, f32, 3e-4), t((3 * HD,), 0.01, f32),
                i8((HD, HD)), t((HD,), 1e-4, f32, 3e-4), t((HD,), 0.01, f32), t((HD,), 0.1, f32, 1.0),
                t((HD,), 0.1, f32), bias, heads, 0.125, 1e-12)
    if name == "selective_scan":
        Bn, Ln, D, N = 2, 9, 16, 8
        return (t((Bn, Ln, D), 1.0, f32), t((Bn, Ln, D), 0.1, f32).abs() + 0.01, -t((D, N), 1.0, f32).abs(),
                t((Bn, Ln, N), 1.0, f32), t((Bn, Ln, N), 1.0, f32), t((D,), 1.0, f32))
    if name == "kan_forward":
        E, Bk, IN, OUT = 2, 5, 8, 24
        grid = torch.linspace(-2.2, 2.2, ks.N_PTS, dtype=f32, device=device).expand(E, IN, ks.N_PTS).contiguous()
        coefs = ks.N_PTS - 1 - ks.ORDER
        return t((Bk, IN), 0.7, f32), grid, t((E, OUT, IN), 0.3, f32), t((E, OUT, IN, coefs), 0.3, f32), ks.ORDER
    raise KeyError(name)


@pytest.mark.parametrize("name", OPS)
def test_op_passes_opcheck_on_the_card(dev, name):
    """Each torch.ops.mdhs op on CUDA tensors: torch.library.opcheck (the schema, the fake
    against the launch's outputs, the autograd registration, a trace with dynamic shapes),
    which launches the kernel."""
    n = WRAPPER[name].launches
    torch.library.opcheck(getattr(torch.ops.mdhs, name).default, op_args(name, dev))
    torch.cuda.synchronize()
    assert WRAPPER[name].launches > n


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


# The bf16 sublayers on the wgmma mainloop (csrc/bf16_gemm.cu): BERT-base widths at ragged
# and small row counts, where the plan (ops/bf16_gemm.py) splits K, and at the main path's
def _attention_args(rng, B, L, HD, heads, dev):
    x = _randn(rng, (B, L, HD), 1.0, dev)
    wqkv, bqkv = _randn(rng, (3 * HD, HD), 0.03, dev), _randn(rng, (3 * HD,), 0.01, dev)
    wo, bo = _randn(rng, (HD, HD), 0.03, dev), _randn(rng, (HD,), 0.01, dev)
    gamma = (1.0 + _randn(rng, (HD,), 0.1, dev)).contiguous()
    beta = _randn(rng, (HD,), 0.1, dev)
    mask = np.ones((B, L), np.float32)
    mask[:, L - L // 5:] = 0.0
    bias = torch.tensor((1.0 - mask) * -1e9, dtype=torch.float32, device=dev)
    return (x, wqkv, bqkv, wo, bo, gamma, beta, bias, heads, float(HD // heads) ** -0.5, 1e-12)


def _ffn_bf16_args(rng, N, H, Di, act, dev):
    x = _randn(rng, (N, H), 1.0, dev)
    w1, b1 = _randn(rng, (Di, H), 0.03, dev), _randn(rng, (Di,), 0.01, dev)
    w2, b2 = _randn(rng, (H, Di), 0.03, dev), _randn(rng, (H,), 0.01, dev)
    gamma = (1.0 + _randn(rng, (H,), 0.1, dev)).contiguous()
    return (x, w1, b1, w2, b2, gamma, _randn(rng, (H,), 0.1, dev), 1e-12, act)


@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("N", [1, 37, 128, 300, 4096])
def test_ffn_block_at_bert_width_matches_plain(dev, N, act):
    args = _ffn_bf16_args(np.random.default_rng(N + 1), N, 768, 3072, act, dev)
    n = fb.ffn_block.launches
    out = fb.ffn_block(*args)
    torch.cuda.synchronize()
    assert fb.ffn_block.launches == n + 1
    _close(out, fb.ffn_block_reference(*args))


_LENGTHS_AND_HEAD_DIMS = [(L, D) for L in (1, 16, 100, 128, 257, 320) for D in (32, 64, 128)]


@pytest.mark.parametrize("L, D", [(L, D) for L, D in _LENGTHS_AND_HEAD_DIMS
                                  if ab.supports(torch.bfloat16, L, 256, 256 // D)])
def test_attention_block_lengths_and_head_dims_match_plain(dev, L, D):
    args = _attention_args(np.random.default_rng(L + D), 2, L, 256, 256 // D, dev)
    n = ab.attention_block.launches
    out = ab.attention_block(*args)
    torch.cuda.synchronize()
    assert ab.attention_block.launches == n + 1
    _close(out, ab.attention_block_reference(*args))


def _other_plan(p, rows, cols, depth, layer_norm):
    """The plan the wrapper does not take at this shape: split three ways if it is
    unsplit, else unsplit (clustered for the LayerNorm GEMM)."""
    tiles = -(-rows // 128) * (cols // 128)
    if p.splits == 1:
        return bg.Plan(128, 3, 1, 3 * tiles)
    return bg.Plan(128, 1, cols // 128 if layer_norm else 1, tiles)


@pytest.mark.parametrize("N", [128, 4096])
def test_ffn_block_split_and_unsplit_plans_match_plain(dev, monkeypatch, N):
    args = _ffn_bf16_args(np.random.default_rng(N + 2), N, 768, 3072, "erf", dev)
    ref = fb.ffn_block_reference(*args)
    own = fb.plans(N, 768, 3072, bg.sm_count(dev))
    other = (_other_plan(own[0], N, 3072, 768, False), _other_plan(own[1], N, 768, 3072, True))
    assert (own[0].splits > 1) == (N == 128) and (other[1].splits > 1) == (N == 4096)
    for plans in (own, other):
        monkeypatch.setattr(fb, "plans", lambda *a, p=plans: p)
        _close(fb.ffn_block(*args), ref)


@pytest.mark.parametrize("B", [1, 32])
def test_attention_block_split_and_unsplit_plans_match_plain(dev, monkeypatch, B):
    args = _attention_args(np.random.default_rng(B + 3), B, 128, 768, 12, dev)
    ref = ab.attention_block_reference(*args)
    M = B * 128
    own = ab.plans(M, 768, bg.sm_count(dev))
    other = (_other_plan(own[0], M, 2304, 768, False), _other_plan(own[1], M, 768, 768, True))
    for plans in (own, other):
        monkeypatch.setattr(ab, "plans", lambda *a, p=plans: p)
        _close(ab.attention_block(*args), ref)


def _close_to_f32(out, ref, atol):
    """A bf16 result against the float32 value it rounds: half a bf16 step of each
    value, and the float32 sums' order."""
    d = (out.float() - ref).abs()
    assert torch.isfinite(out.float()).all()
    assert bool((d <= 2.0 ** -8 * ref.abs() + atol).all()), d.max().item()


def _plan_as(monkeypatch, split):
    """Make bg.plan give the split plan, or the unsplit one, whichever its own is."""
    own = bg.plan

    def plan(rows, cols, depth, layer_norm, sms):
        p = own(rows, cols, depth, layer_norm, sms)
        return p if split == (p.splits > 1) else _other_plan(p, rows, cols, depth, layer_norm)

    monkeypatch.setattr(bg, "plan", plan)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("M, N, K", [(1, 2304, 768), (128, 3072, 768), (300, 768, 3072), (4096, 2304, 768)])
def test_tile_gemm_alone_matches_float32_matmul(dev, monkeypatch, M, N, K, split):
    rng = np.random.default_rng(M + K)
    a, w, b = _randn(rng, (M, K), 1.0, dev), _randn(rng, (N, K), 0.03, dev), _randn(rng, (N,), 0.01, dev)
    _plan_as(monkeypatch, split)
    _close_to_f32(bg.tile_gemm(a, w, b), a.float() @ w.float().t() + b.float(), 1e-3)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("M, H, K", [(1, 768, 768), (128, 768, 3072), (300, 256, 384), (4096, 768, 3072),
                                     (200, 1024, 1024)])
def test_ln_gemm_alone_matches_float32_matmul(dev, monkeypatch, M, H, K, split):
    rng = np.random.default_rng(M + H + K)
    a, w, b = _randn(rng, (M, K), 1.0, dev), _randn(rng, (H, K), 0.03, dev), _randn(rng, (H,), 0.01, dev)
    x, g, beta = _randn(rng, (M, H), 1.0, dev), (1.0 + _randn(rng, (H,), 0.1, dev)).contiguous(), \
        _randn(rng, (H,), 0.1, dev)
    _plan_as(monkeypatch, split)
    y = x.float() + a.float() @ w.float().t() + b.float()
    _close_to_f32(bg.ln_gemm(a, w, b, x, g, beta, 1e-12), bg.layer_norm_f32(y, g, beta, 1e-12), 2e-3)


def test_bf16_sublayers_raise_instead_of_falling_back(dev, monkeypatch):
    rng = np.random.default_rng(5)
    for L, HD, heads in ((336, 768, 12), (257, 512, 4), (64, 512, 2)):  # past the gate; head_dim 256
        with pytest.raises(ValueError, match="unsupported"):
            ab.attention_block(*_attention_args(rng, 1, L, HD, heads, dev))
    with pytest.raises(ValueError, match="unsupported"):
        fb.ffn_block(*_ffn_bf16_args(rng, 8, 768, 3000, "erf", dev))
    a, w, b = _randn(rng, (128, 768), 1.0, dev), _randn(rng, (768, 768), 0.03, dev), _randn(rng, (768,), 0.01, dev)
    for p in (bg.Plan(128, 13, 1, 78), bg.Plan(256, 2, 1, 6), bg.Plan(128, 1, 2, 6)):  # no kernel runs these
        monkeypatch.setattr(bg, "plan", lambda *args, p=p: p)
        with pytest.raises(RuntimeError, match="CUDA error"):
            bg.tile_gemm(a, w, b)
    for p in (bg.Plan(128, 1, 1, 6), bg.Plan(128, 2, 6, 12)):
        monkeypatch.setattr(bg, "plan", lambda *args, p=p: p)
        with pytest.raises(RuntimeError, match="CUDA error"):
            bg.ln_gemm(a, w, b, a, b, b, 1e-12)
    torch.cuda.synchronize()


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


def _ffn_args(N, H, Di, act, dev):
    rng = np.random.default_rng(N)
    x = _randn(rng, (N, H), 1.0, dev)
    w1, s1 = quantize_weight(_randn(rng, (Di, H), 0.03, dev))
    w2, s2 = quantize_weight(_randn(rng, (H, Di), 0.03, dev))
    return (x, w1, s1, _f32(rng, (Di,), 0.01, dev), w2, s2, _f32(rng, (H,), 0.01, dev),
            _f32(rng, (H,), 0.1, dev, 1.0), _f32(rng, (H,), 0.1, dev), 1e-12, act)


# The int8 FFN (csrc/int8_ffn_block.cu on csrc/gemm_sm90.cuh) at ragged and at
# the preset's shapes, batch 1 (128 rows) and batch 512 (65,536), H 384 and 1024, and
# both widths of GEMM1's tiles (128 columns at few rows or Di not a multiple of 256,
# 256 where they fill the card). Its scratch too: sh is the plain version's bit for
# bit, h_i8 within 1 of it, with under 0.1 % of the values apart.
@pytest.mark.parametrize("act", ["erf", "tanh"])
@pytest.mark.parametrize("N, H, Di", [(1, 128, 256), (37, 128, 384), (300, 768, 3072), (128, 768, 3072),
                                      (65536, 768, 3072), (300, 384, 1536), (4096, 1024, 4096), (2000, 384, 1408)])
def test_int8_ffn_block_kernel_matches_plain(dev, N, H, Di, act):
    args = _ffn_args(N, H, Di, act, dev)
    n = qk.int8_ffn_block.launches
    out, h_q, sh = qk.launch_int8_ffn_block(*args)
    torch.cuda.synchronize()
    assert qk.int8_ffn_block.launches == n + 1
    _close_int8(out, qk.int8_ffn_block_reference(*args))
    hq_ref, sh_ref = qk.ffn_hidden_quant_reference(*args[:4], act)
    assert torch.equal(sh, sh_ref)
    d = (h_q.int() - hq_ref.int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3


def test_int8_ffn_block_keeps_no_float32_hidden(dev):
    """No (N, Di) float32 scratch: the call's peak allocation stays under one."""
    N, H, Di = 65536, 768, 3072
    args = _ffn_args(N, H, Di, "tanh", dev)
    qk.int8_ffn_block(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    qk.int8_ffn_block(*args)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < N * Di * 4


def test_int8_ffn_block_raises_outside_its_gate(dev):
    args = list(_ffn_args(64, 1152, 4608, "erf", dev))  # wider than the LayerNorm cluster
    with pytest.raises(ValueError, match="unsupported"):
        qk.int8_ffn_block(*args)
    args = list(_ffn_args(64, 768, 3072, "erf", dev))
    args[0] = args[0].float()
    with pytest.raises(ValueError, match="unsupported"):
        qk.int8_ffn_block(*args)


# The int8 attention block (csrc/int8_attention_block.cu): L from 1 to 512 (ragged, inside
# and at the 128-key tile), the preset's (512, 128); head_dim 32, 64 and 128; the QKV
# product on 128-column tiles (few rows, or 3 HD not a multiple of 256) and on 256; the
# LayerNorm cluster from 1 to 8 blocks. Its scratch too: x_i8, sx and qkv are the plain
# version's bit for bit, ctx within fused_attention's bf16 bound of the plain core on the
# same qkv, out within the int8 bound; a second launch gives the same bits.
@pytest.mark.parametrize("B, L, HD, heads", [(2, 16, 128, 2), (3, 100, 128, 4), (2, 128, 768, 12),
                                             (1, 256, 768, 12), (2, 1, 128, 2), (2, 333, 768, 12),
                                             (1, 512, 768, 12), (512, 128, 768, 12), (3, 77, 384, 6),
                                             (2, 100, 1024, 8)])
def test_int8_attention_block_kernel_matches_plain(dev, B, L, HD, heads):
    rng = np.random.default_rng(L)
    x = _randn(rng, (B, L, HD), 1.0, dev)
    wqkv, sqkv = quantize_weight(_randn(rng, (3 * HD, HD), 0.03, dev))
    wo, so = quantize_weight(_randn(rng, (HD, HD), 0.03, dev))
    args = (x, wqkv, sqkv, _f32(rng, (3 * HD,), 0.01, dev), wo, so, _f32(rng, (HD,), 0.01, dev),
            _f32(rng, (HD,), 0.1, dev, 1.0), _f32(rng, (HD,), 0.1, dev), _bias(rng, B, L, dev),
            heads, float(HD // heads) ** -0.5, 1e-12)
    n = qk.int8_attention_block.launches
    out, x_q, sx, qkv, ctx = qk.launch_int8_attention_block(*args)
    torch.cuda.synchronize()
    assert qk.int8_attention_block.launches == n + 1
    x_q_ref, sx_ref, qkv_ref, ctx_ref, _, _, out_ref = qk.int8_attention_stages_reference(*args)
    assert torch.equal(x_q, x_q_ref) and torch.equal(sx, sx_ref) and torch.equal(qkv, qkv_ref)
    _close(ctx, ctx_ref)
    _close_int8(out, out_ref)
    again = qk.launch_int8_attention_block(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, x_q, sx, qkv, ctx)))


def test_int8_attention_block_raises_outside_its_gate(dev):
    rng = np.random.default_rng(0)
    for B, L, HD, heads in ((1, 513, 768, 12), (1, 64, 1152, 12), (1, 64, 384, 32)):
        x = _randn(rng, (B, L, HD), 1.0, dev)
        w, s = quantize_weight(_randn(rng, (3 * HD, HD), 0.03, dev))
        v = _f32(rng, (HD,), 0.1, dev)
        with pytest.raises(ValueError, match="unsupported"):
            qk.int8_attention_block(x, w, s, _f32(rng, (3 * HD,), 0.01, dev), w[:HD], s[:HD], v, v, v,
                                    _bias(rng, B, L, dev), heads, 0.125, 1e-12)


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
# precision); its backward within 1e-5 of the largest gradient in float32 and one
# bf16 ulp in bf16 (both kernels' plans in tests/test_torch_port_bn_stats.py).
from mdhs_tpu_torch.models.norm import BatchNorm2d  # noqa: E402
from mdhs_tpu_torch.ops import augment as aug  # noqa: E402
from mdhs_tpu_torch.ops import bn_stats as bns  # noqa: E402
from mdhs_tpu_torch.ops import shear as sh  # noqa: E402


# The column-strip shear (8 output rows a thread, 4 strips a block): the training
# step's pads 17 and 31 and the baseline family's 49 and 82, W not a multiple of the
# strip or of the 32-row block, L not a multiple of the 32-lane warp, B * C = 1; a
# second launch gives the same bits.
@pytest.mark.parametrize("B, C, W, L, pad", [(32, 3, 224, 224, 17), (32, 3, 224, 224, 31), (4, 3, 224, 224, 49),
                                             (4, 3, 224, 224, 82), (3, 2, 37, 45, 5), (1, 1, 1, 1, 1),
                                             (2, 3, 37, 45, 17), (1, 1, 13, 33, 3), (1, 1, 224, 200, 31),
                                             (1, 1, 7, 1, 2)])
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
    assert torch.equal(out, sh.shear_sublane(x, d, pad))


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


# the first five as before; then the rest of ResNet50's 12 BatchNorm input shapes at batch
# 32, C 36 (72-byte rows: the plain-load path in bf16) and R just under the 2^24 gate
BN_SHAPES = [(32 * 56 * 56, 64), (32 * 7 * 7, 2048), (1000, 40), (129, 3), (1, 5), (401408, 64), (100352, 256),
             (25088, 512), (100352, 128), (25088, 128), (6272, 1024), (25088, 256), (6272, 256), (6272, 512),
             (1568, 512), (777, 36), ((1 << 24) - 1, 8)]


def _stats_input(shape, dtype, dev):
    rng = np.random.default_rng(shape[0] + shape[1])
    return torch.from_numpy((rng.standard_normal(shape) * 3 + 5).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_stats_kernel_matches_plain(dev, shape, dtype):
    x = _stats_input(shape, dtype, dev)
    n = bns.bn_stats.launches
    got = bns.bn_stats(x)
    torch.cuda.synchronize()
    assert bns.bn_stats.launches == n + 1
    assert got[0].dtype == got[1].dtype == torch.float32
    _close_stats(got, bns.bn_stats_reference(x), x)


@pytest.mark.parametrize("shape", [(401408, 64), (100352, 256), (1568, 2048), (129, 3)])
def test_bn_stats_kernel_gives_the_same_bits_twice(dev, shape):
    """The blocks' partials are combined in a fixed order inside the launch: the
    schedule does not reach the result, and the kept counters are back at zero."""
    x = _stats_input(shape, torch.bfloat16, dev)
    a, b = bns.bn_stats(x), bns.bn_stats(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for _, counters in bns._workspaces.values():
        assert int(counters.count_nonzero()) == 0


def test_bn_stats_kernel_takes_plain_loads_off_alignment(dev):
    base = _stats_input((4097, 64), torch.bfloat16, dev).reshape(-1)
    x = base[4:4 + 4096 * 64].view(4096, 64)  # 8 bytes past a 16-byte boundary
    assert x.data_ptr() % 16 == 8
    _close_stats(bns.bn_stats(x), bns.bn_stats_reference(x), x)


def _one_bf16_ulp(got, want):
    a = torch.maximum(got.float().abs(), want.float().abs()).clamp(min=torch.finfo(torch.float32).tiny)
    return bool(((got.float() - want.float()).abs() <= torch.exp2(torch.floor(torch.log2(a)) - 7)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(401408, 64), (100352, 256), (1568, 2048), (1000, 40), (129, 3), (777, 36)])
def test_bn_stats_backward_kernel_matches_plain(dev, shape, dtype):
    x = _stats_input(shape, dtype, dev)
    C = shape[1]
    g = torch.Generator(device=dev).manual_seed(C)
    mean, dmean, dvar = (torch.randn(C, device=dev, generator=g) for _ in range(3))
    n = bns.bn_stats_backward.launches
    got = bns.bn_stats_backward(x, mean, dmean, dvar)
    torch.cuda.synchronize()
    assert bns.bn_stats_backward.launches == n + 1
    want = bns.bn_stats_backward_reference(x, mean, dmean, dvar)
    assert got.dtype == want.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)
    else:
        assert _one_bf16_ulp(got, want)


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


def test_bn_stats_autograd_launches_both_kernels_once(dev):
    x = _stats_input((8 * 28 * 28, 128), torch.bfloat16, dev).requires_grad_()
    n, nb = bns.bn_stats.launches, bns.bn_stats_backward.launches
    m, v = bns.bn_stats(x.view(8, 28, 28, 128))
    assert (bns.bn_stats.launches, bns.bn_stats_backward.launches) == (n + 1, nb)
    v.sum().backward()  # dmean is zero, dvar an expanded scalar
    assert (bns.bn_stats.launches, bns.bn_stats_backward.launches) == (n + 1, nb + 1)
    want = bns.bn_stats_backward_reference(x.detach(), m.detach(), torch.zeros_like(m), torch.ones_like(v))
    assert x.grad.dtype == torch.bfloat16 and _one_bf16_ulp(x.grad, want)


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
    stats = [torch.zeros(32, device=dev) for _ in range(3)]
    with pytest.raises(ValueError, match="unsupported"):
        bns.bn_stats_backward(torch.zeros((64, 32), device=dev, dtype=torch.float16), *stats)
    with pytest.raises(ValueError, match="unsupported"):
        bns.bn_stats(torch.zeros((1 << 24, 1), device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dmean must be float32"):
        bns.bn_stats_backward(torch.zeros((64, 32), device=dev), stats[0], stats[1].double(), stats[2])


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
                                        (2, 70, 512, 128), (1, 1, 1, 1), (64, 49, 64, 16)])  # the last vmamba's
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


@pytest.mark.parametrize("L", [1, 37, 49, 196])  # 37: not a multiple of the kernel's 16-step chunk
@pytest.mark.parametrize("D, N", [(130, 8), (130, 16), (72, 17), (100, 128)])  # D past the block's channels
def test_selective_scan_lengths_and_state_sizes_match_plain(dev, L, D, N):
    args = _scan_args(np.random.default_rng(7 * L + N), 2, L, D, N, dev)
    n = ss.selective_scan.launches
    out = ss.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == n + 1
    _close_f32(out, ss.selective_scan_reference(*args))


# E (None: one layer, no expert axis), B, IN, OUT, x shared: E 1 and 4, ragged B (1, 33, 64, and
# past a tile: 130), IN not a multiple of the 32-input stage (and not of 4: Wb's padded pitch),
# OUT 7 and 16 (narrow tiles), 65, 200 and 1024 (wide)
_KAN_PLAN_CASES = [(4, 64, 256, 1024, True), (4, 64, 1024, 7, False), (1, 33, 100, 65, True), (4, 1, 37, 7, False),
                   (4, 33, 70, 1024, False), (None, 64, 20, 65, False), (1, 1, 9, 1024, False),
                   (4, 64, 256, 16, True), (2, 130, 40, 9, False), (2, 130, 64, 200, True)]


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("E, B, IN, OUT, shared", _KAN_PLAN_CASES)
def test_kan_forward_plans_match_plain(dev, monkeypatch, E, B, IN, OUT, shared, split):
    """Both orientations on the split plan (the wrapper's, for 132 SMs) and unsplit
    (the plan for a card of one SM), twice in a row: the split-K counters are left
    at zero for the next launch."""
    if not split:
        monkeypatch.setattr(ks, "_sm_count", lambda index: 1)
    p = ks.plan(E or 1, B, IN, OUT, ks._sm_count(dev.index))
    assert (p.splits > 1) == split or -(-IN // 32) == 1
    args = _kan_args(np.random.default_rng(B + IN + OUT), E, B, IN, OUT, dev, shared)
    ref = ks.kan_forward_reference(*args)
    for _ in range(2):
        out = ks.kan_forward(*args)
        torch.cuda.synchronize()
        _close_f32(out, ref)


def test_kan_forward_kept_tensor_maps_follow_the_weights(dev):
    """Two weight sets of one shape in turns: the weights' tensor maps are kept by
    their arguments, so each call reads its own weights; each call is tallied
    under its layer's (IN, OUT)."""
    x, grid, bw, sw = _kan_args(np.random.default_rng(11), 4, 64, 256, 1024, dev, True)
    other = (bw.flip(1).contiguous(), (sw * -0.5).contiguous())
    refs = [ks.kan_forward_reference(x, grid, bw, sw), ks.kan_forward_reference(x, grid, *other)]
    before = ks.kan_forward.launches_by_layer.get((256, 1024), 0)
    for i in range(4):
        out = ks.kan_forward(x, grid, *((bw, sw) if i % 2 == 0 else other))
        torch.cuda.synchronize()
        _close_f32(out, refs[i % 2])
    assert ks.kan_forward.launches_by_layer[256, 1024] == before + 4


@pytest.mark.parametrize("field, delta", [("row_tiles", -1), ("row_tiles", 1), ("col_tiles", -1), ("col_tiles", 1)])
def test_kan_forward_entry_rejects_tiles_that_do_not_cover(dev, monkeypatch, field, delta):
    """The plan is the tiling's one source; the entry refuses tiles that miss
    outputs or leave a tile empty, rather than index past the counters."""
    plan = ks.plan

    def off(E, *a):
        p = plan(E, *a)
        p = dataclasses.replace(p, **{field: getattr(p, field) + delta})
        return dataclasses.replace(p, tiles=E * p.row_tiles * p.col_tiles)

    monkeypatch.setattr(ks, "plan", off)
    args = _kan_args(np.random.default_rng(12), 4, 130, 256, 200, dev, False)
    with pytest.raises(RuntimeError, match="kan_forward: CUDA error"):
        ks.kan_forward(*args)


def test_moe_bank_makes_no_copy_in_a_warm_forward(dev):
    """The stacked, scaled weights are made once: two warm forwards hand kan_forward
    the same tensors, and the result is the per-forward stack's."""
    moe = moe_mod.MoE(48, 7, num_experts=4, k=2, expert_layers=(48, 96, 7), device=dev)
    init_parameters(moe, torch.Generator(device=dev).manual_seed(3))
    x = torch.tensor(np.random.default_rng(4).standard_normal((20, 48)), dtype=torch.float32, device=dev)
    with torch.inference_mode():
        moe(x)
        made = [tuple(t.data_ptr() for t in layer) for layer in moe.stacked_layers()]
        n = ks.kan_forward.launches
        out, _ = moe(x)
        assert ks.kan_forward.launches == n + 2
        assert [tuple(t.data_ptr() for t in layer) for layer in moe._bank] == made
        h = x
        for i in range(2):
            bank = [e.layers[i] for e in moe.experts]
            h = ks.kan_forward(h.contiguous(), torch.stack([l.grid for l in bank]),
                               torch.stack([l.base_weight for l in bank]),
                               torch.stack([l.scaled_spline_weight() for l in bank]))
    torch.testing.assert_close(moe.expert_bank(x), h, atol=0, rtol=0)


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
from mdhs_tpu_torch.diagnostics import trace  # noqa: E402
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


def test_ablation_device_split_traces_every_launch(dev):
    """The profiler's records of the chain's eager run hold all K_STEPS
    launches of the kernel, trace after trace, without a second try; the
    split's parts are positive."""
    q, k, v, bias, heads, _ = _ablate_args(8, 128, 768, 12, dev)
    bias = torch.zeros_like(bias)
    chain = diag.build("full", dev, 8, 128, 12, 64)
    for _ in range(20):
        events = trace.kernel_events(lambda: chain.eager(q, k, v, bias))
        assert sum("attention_ablate_kernel" in e.name for e in events) == chain.steps
    split = diag.device_split(chain, q, k, v, bias)
    assert split["kernel_device_ms"] > 0 and min(split["chain_device_ms_per_step"].values()) > 0


# --------------------------------------------------------------------------- ConNexT's path
from mdhs_tpu_torch.models.connext import ConNexTClassifier, ConNexTConfig  # noqa: E402
from mdhs_tpu_torch.models.convnext import register_convnext_variant  # noqa: E402

# ConNexT's MoE bank, [768, 512, 128, 32, 7] over 4 experts at batch 32: layer 0's x shared
# (32 batch rows: half a 64-row tile), OUT 32 on the wide orientation (32 of 128 weight rows),
# IN 32 a single stage, OUT 7 on narrow 8-column tiles
_CONNEXT_BANK = [(4, 32, 768, 512, True), (4, 32, 512, 128, False), (4, 32, 128, 32, False), (4, 32, 32, 7, False)]


@pytest.mark.parametrize("E, B, IN, OUT, shared", _CONNEXT_BANK)
def test_kan_forward_connext_bank_shapes_match_plain(dev, E, B, IN, OUT, shared):
    """Each layer of the bank at the served batch 32 and at batch 1."""
    for b in (B, 1):
        args = _kan_args(np.random.default_rng(b + IN + OUT), E, b, IN, OUT, dev, shared)
        n = ks.kan_forward.launches
        out = ks.kan_forward(*args)
        torch.cuda.synchronize()
        assert ks.kan_forward.launches == n + 1
        _close_f32(out, ks.kan_forward_reference(*args))


def test_connext_kernel_path_matches_plain_path(dev, monkeypatch):
    """A bf16 ConNexT with one BERT-base layer at seq 512, a pico ConvNeXt and the
    reference's bank [768, 512, 128, 32, 7]: a forward launches fused_attention and
    ffn_block once and kan_forward four times, and nothing else. Against the same
    weights on the plain path (attention_impl "xla", kan_forward's plain version):
    BERT's CLS within the bf16 bound, the ConvNeXt map bit for bit (the same cuDNN
    path), the head on equal inputs within 2^-6 of max |logit| (kan_forward's output
    is cast to bf16), the logits within 2^-4 of max |logit| and mean 2^-7 of it
    (chip_smoke.py's CONNEXT_LOGIT_MAX / _MEAN say why). As in chip_smoke.py's
    connext phase, the layer scales are 0.5, the image-side query and key
    convolutions are scaled by 768^-0.25 (the unscaled softmax off saturation), and
    the gate reads the rows' principal directions, its logits of std 2."""
    register_convnext_variant("cuda_pico", (1, 1, 1, 1), (32, 32, 32, 64))
    bert = BertConfig(vocab_size=512, num_hidden_layers=1)
    cfg = ConNexTConfig(convnext_variant="cuda_pico", head="moe", bert=bert)
    g = torch.Generator(device=dev).manual_seed(0)
    model = init_parameters(ConNexTClassifier(cfg, device=dev, dtype=torch.bfloat16), g).eval()
    rng = np.random.default_rng(1)
    n = 6
    img = torch.tensor(rng.standard_normal((n, 3, 64, 64)), dtype=torch.bfloat16, device=dev)
    ids = torch.tensor(rng.integers(0, 512, (n, 512)), device=dev)
    mask = torch.ones((n, 512), dtype=torch.int64, device=dev)
    mask[1, 300:] = 0
    with torch.no_grad():
        for conv in (model.imagbased_cross_attention.query_conv, model.imagbased_cross_attention.key_conv):
            conv.weight.mul_(768 ** -0.25)
        for stage in model.image_encoder.encoder.stages:
            for layer in stage.layers:
                layer.layer_scale_parameter.fill_(0.5)
        feats = model.forward_features(img, ids, mask).float()
        m = feats.mean(dim=0)
        w = torch.linalg.svd(feats - m, full_matrices=False)[2][:4].T
        w -= m[:, None] * (m @ w)[None, :] / (m @ m)
        model.moe.w_gate.copy_(w / ((feats - m) @ w).std(dim=0) * 2.0)
    plain = ConNexTClassifier(dataclasses.replace(cfg, bert=dataclasses.replace(bert, attention_impl="xla")),
                              device=dev, dtype=torch.bfloat16).eval()
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        before = _counts() + (ks.kan_forward.launches,)
        logits, balance = model(img, ids, mask)
        launched = [a - b for a, b in zip(_counts() + (ks.kan_forward.launches,), before)]
        assert launched == [0, 1, 1, 0, 0, 4], launched
        assert logits.dtype == torch.float32 and logits.shape == (n, 7) and torch.isfinite(logits).all()
        cls, fmap = model.towers(img, ids, mask)
        cls_plain, fmap_plain = plain.towers(img, ids, mask)
        _close(cls, cls_plain)
        assert torch.equal(fmap, fmap_plain)
        fused = model.fuse(cls, fmap)
        head, _ = model.classify(fused)
        with monkeypatch.context() as mp:
            mp.setattr(moe_mod._ks, "kan_forward", ks.kan_forward_reference)
            head_plain, _ = model.classify(fused)
            logits_plain, _ = plain(img, ids, mask)
    scale = head_plain.abs().max().item()
    assert (head - head_plain).abs().max().item() <= 2.0 ** -6 * scale
    d, scale = (logits - logits_plain).abs(), logits_plain.abs().max().item()
    assert d.max().item() <= 2.0 ** -4 * scale and d.mean().item() <= 2.0 ** -7 * scale, (d.max().item(), scale)


@pytest.mark.parametrize("rows, C", [(32 * 56 * 56, 128), (32 * 7 * 7, 1024), (5, 768)])
def test_bf16_layer_norm_takes_float32_statistics(dev, rows, C):
    """ConvNeXt's LayerNorms (eps 1e-6) on bf16 activations, as flax computes them:
    statistics in float32, the output rounded once to bf16. F.layer_norm on a bf16
    CUDA tensor against the float32 plain path on the same values: within one bf16
    step of each output, plus 1e-5 for the float32 rounding of terms of up to ~10
    that cancel near 0 (the two differ only in float32 rounding before the last
    one), on rows with a mean far from 0 (where a bf16 mean or variance would be
    off by far more)."""
    g = torch.Generator(device=dev).manual_seed(rows + C)
    x = (torch.randn((rows, C), generator=g, device=dev) * 2.0 + 8.0).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
    b = (0.1 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
    out = torch.nn.functional.layer_norm(x, (C,), w, b, 1e-6)
    ref = torch.nn.functional.layer_norm(x.float(), (C,), w.float(), b.float(), 1e-6)
    assert out.dtype == torch.bfloat16
    bound = torch.finfo(torch.bfloat16).eps * ref.abs() + 1e-5
    assert bool(((out.float() - ref).abs() <= bound).all())


# --- the inference entry points (mdhs_tpu_torch/cli) on the card -----------------------------
import json  # noqa: E402
from pathlib import Path  # noqa: E402

from mdhs_tpu_torch.cli import run_predict  # noqa: E402
from mdhs_tpu_torch.core.checkpoint import save_checkpoint  # noqa: E402
from mdhs_tpu_torch.core.config import load_config  # noqa: E402
from mdhs_tpu_torch.data import png  # noqa: E402
from mdhs_tpu_torch.models import build_model  # noqa: E402
from mdhs_tpu_torch.data.tokenizer import WordPieceTokenizer  # noqa: E402

_CLI_CASES = {  # family: (resolved config, overrides): a few layers of width the kernels take
    "mibf": ("mibf_ham.json", []),
    "baseline": ("ham_fusion_ssm_v1.json", ["model.fusion_type=multiscale", "model.classifier_type=mlp"]),
}


@pytest.mark.parametrize("family", sorted(_CLI_CASES))
def test_run_predict_on_the_card_matches_the_cpu_plain_path(dev, tmp_path, family):
    """run_predict over 6 PNGs of three sizes at canvas 72 / crop 64, seq 128, batch 4 (two
    batches, the last of 2 rows), with BERT-base in bf16 from a port checkpoint: on the card
    each batch launches attention_block and ffn_block 12 times; the same call with
    --device cpu runs the plain path. The logits agree within the MIBF model bound
    (PERF.md section 2: max <= 0.15, mean < 0.01) and the CSVs list the same images."""
    config, overrides = _CLI_CASES[family]
    rng = np.random.default_rng(3)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    names = [f"img_{i}.png" for i in range(6)]
    for i, name in enumerate(names):
        png.write_png(str(img_dir / name), rng.integers(0, 256, (60 + 20 * (i % 3), 80, 3), dtype=np.uint8))
    (tmp_path / "d.json").write_text(json.dumps(
        [{"image_info": n, "description": f"irregular pigment network {i} border"} for i, n in enumerate(names)]))
    (tmp_path / "labels.csv").write_text("image_id,label\n" + "".join(f"{n},{i % 7}\n" for i, n in enumerate(names)))
    cfg = load_config(Path(__file__).resolve().parent.parent / "mdhs_tpu_torch" / "configs" / config,
                      overrides=overrides + ["data.canvas=72", "data.image_size=64", "training.batch_size=4",
                                             "tokenizer.max_length=128", f"data.test_image_dir={img_dir}",
                                             f"data.test_json_path={tmp_path / 'd.json'}",
                                             f"data.test_label_csv={tmp_path / 'labels.csv'}"])
    cfg.save_json(tmp_path / "cfg.json")
    model = build_model(cfg, family, WordPieceTokenizer.synthetic(30522), dtype=torch.float32)
    init_parameters(model, torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "w.pt"), model)
    out = {}
    for device in ("cuda", "cpu"):
        before = _counts()
        out[device] = run_predict.main(["--config", str(tmp_path / "cfg.json"), "--model_path", str(tmp_path / "w.pt"),
                                        "--output_path", str(tmp_path / f"{device}.csv"), "--family", family,
                                        "--device", device])
        launched = [a - b for a, b in zip(_counts(), before)]
        assert launched == ([24, 24, 0, 0, 0] if device == "cuda" else [0] * 5), (device, launched)
    d = np.abs(out["cuda"]["logits"] - out["cpu"]["logits"])
    assert np.isfinite(out["cuda"]["logits"]).all() and out["cuda"]["logits"].shape == (6, 7)
    assert d.max() <= 0.15 and d.mean() < 0.01, (d.max(), d.mean())
    assert out["cuda"]["image_ids"] == out["cpu"]["image_ids"] == names


# --------------------------------------------------------------------------- the baseline family's training
def test_selective_scan_gradient_on_the_card_matches_the_cpu(dev):
    """The op's forward launches the kernel once, and its backward (the associative
    scan's VJP, plain ops on the card) gives the CPU's six gradients within 1e-4 of
    each one's max |cpu|."""
    args = _scan_args(np.random.default_rng(7), 8, 49, 64, 16, dev)
    g = torch.randn((8, 49, 64), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    leaves = [a.clone().requires_grad_() for a in args]
    n = ss.selective_scan.launches
    ss.selective_scan(*leaves).backward(g)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == n + 1
    cpu = [a.detach().cpu().requires_grad_() for a in args]
    ss.selective_scan(*cpu).backward(g.cpu())
    for leaf, ref in zip(leaves, cpu):
        _close_f32(leaf.grad.cpu(), ref.grad)


def test_stain_normalize_on_the_card_matches_the_cpu_and_makes_no_host_copy(dev):
    from mdhs_tpu_torch.ops.stain_norm import stain_normalize

    x = torch.rand((4, 64, 48, 3), generator=torch.Generator().manual_seed(3))
    ref = stain_normalize(x)
    xd = x.to(dev)
    stain_normalize(xd)  # the constants are made once per device, here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = stain_normalize(xd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float((out.cpu() - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("fusion, head, kernel, per_step", [("mamba", "mlp", "selective_scan", 1),
                                                            ("multiscale", "moe", "kan_forward", 2),
                                                            ("multiscale", "kan", None, 0)])
def test_baseline_trainer_step_launches_its_kernels(dev, fusion, head, kernel, per_step):
    """A baseline step launches the three shears and the fusion's scan or the MoE
    bank's two layers (the backward takes the plain VJPs, no kernel)."""
    import dataclasses as dc

    from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer

    bert = BertConfig(vocab_size=512, num_hidden_layers=1, intermediate_size=512, max_position_embeddings=128)
    preset = dc.replace(MIBF_HAM_TRAIN, bert=bert, batch_size=4, seq_len=40, canvas=72, image_size=64,
                        family="baseline", degrees=45.0, vflip=True, color_jitter=True, normalize=True,
                        stain=((150.0, 140.0, 140.0), (20.0, 20.0, 20.0)))
    cfg = BaselineConfig(hidden_dim=32, num_heads=4, fusion_type=fusion, classifier_type=head, bert=bert)
    model = init_parameters(MultimodalBaselineModel(cfg, device=dev), torch.Generator(device=dev).manual_seed(0))
    trainer = Trainer(preset, model=model, device=dev)
    rng = np.random.default_rng(2)
    batch = {"image": rng.integers(0, 256, (4, 72, 72, 3), dtype=np.uint8),
             "input_ids": rng.integers(0, 512, (4, 40)), "attention_mask": np.ones((4, 40), np.int64),
             "label": rng.integers(0, 7, 4), "n_valid": np.int32(3)}
    launches = {k: m.launches for k, m in (("shear", sh.shear_sublane), ("selective_scan", ss.selective_scan),
                                           ("kan_forward", ks.kan_forward))}
    m = trainer.train_step(batch)
    torch.cuda.synchronize()
    got = {k: mod.launches - launches[k] for k, mod in (("shear", sh.shear_sublane),
                                                        ("selective_scan", ss.selective_scan),
                                                        ("kan_forward", ks.kan_forward))}
    want = {"shear": 3, "selective_scan": 0, "kan_forward": 0}
    if kernel:
        want[kernel] = per_step
    assert got == want and bool(torch.isfinite(m["loss"]))


# --------------------------------------------------------------------------- the baseline's branches (Spine)
# The Spine sequence configurations augment a (64, 5) stack of slices as one batch of 320: the
# shear at N = 320, both of its pads, bit for bit against its plain version. The branch modules in
# bf16 on the card against their float32 plain forms on the same weights: max |d| within 2^-5 of the
# largest float32 output and mean |d| within 2^-8 of it (a few bf16 steps of rounding through
# the recurrence's five steps, the transformer's layer, the resize's two products).
from mdhs_tpu_torch.models.baseline import center_crop_resize  # noqa: E402
from mdhs_tpu_torch.modules.gating import DualExpertGate  # noqa: E402
from mdhs_tpu_torch.modules.sequence import SequenceEncoder  # noqa: E402
from mdhs_tpu_torch.modules.tabular import TabularEncoder  # noqa: E402


@pytest.mark.parametrize("pad", [49, 82])
def test_shear_kernel_at_the_spine_stack_of_320_is_bit_exact(dev, pad):
    rng = np.random.default_rng(320 + pad)
    x = torch.zeros((320, 3, 224 + 2 * pad, 224), dtype=torch.float32)
    x[:, :, pad:pad + 224] = torch.from_numpy(rng.random((320, 3, 224, 224), dtype=np.float32))
    d = torch.from_numpy((rng.uniform(-1, 1, (320, 224)) * (pad - 0.01)).astype(np.float32))
    x, d = x.to(dev), d.to(dev)
    assert sh.supports(tuple(x.shape), x.dtype, pad)
    n = sh.shear_sublane.launches
    out = sh.shear_sublane(x, d, pad)
    torch.cuda.synchronize()
    assert sh.shear_sublane.launches == n + 1
    assert torch.equal(out, sh.shear_reference(x, d, pad))


def test_five_d_stack_augments_through_the_kernel_as_one_batch(dev):
    """A (B, T) stack's augmentation launches three shears over B * T images, bit for bit
    the plain shear's, and comes back as (B, T, 3, out, out)."""
    g = torch.Generator(device=dev).manual_seed(3)
    imgs = torch.randint(0, 256, (4, 5, 72, 72, 3), dtype=torch.uint8, device=dev, generator=g)
    p = aug.sample_crop_flip_rotate(20, 72, g, vflip=True, degrees=45.0)
    n = sh.shear_sublane.launches
    out = aug.train_pipeline(imgs, g, 64, degrees=45.0, vflip=True, params=p, normalize=True)
    assert sh.shear_sublane.launches == n + 3 and out.shape == (4, 5, 3, 64, 64)
    real = aug.shear_sublane
    aug.shear_sublane = sh.shear_reference
    try:
        ref = aug.train_pipeline(imgs, g, 64, degrees=45.0, vflip=True, params=p, normalize=True)
    finally:
        aug.shear_sublane = real
    assert torch.equal(out, ref)


def _bf16_close(out, ref):
    out, ref = out.float().cpu(), ref.float().cpu()
    scale = ref.abs().max().item()
    d = (out - ref).abs()
    assert torch.isfinite(out).all() and d.max().item() <= 2.0 ** -5 * scale and d.mean().item() <= 2.0 ** -8 * scale, \
        (d.max().item(), d.mean().item(), scale)


@pytest.mark.parametrize("kind, bi, layers", [("lstm", True, 1), ("lstm", False, 2), ("gru", True, 1),
                                              ("transformer", True, 1)])
def test_sequence_encoder_in_bf16_matches_float32(dev, kind, bi, layers):
    g = torch.Generator().manual_seed(7)
    f32 = init_parameters(SequenceEncoder(256, 256, kind, layers, bi, 0.0, 4), g).eval()
    bf16 = init_parameters(SequenceEncoder(256, 256, kind, layers, bi, 0.0, 4), torch.Generator().manual_seed(7))
    bf16 = bf16.to(dev, torch.bfloat16).eval()
    x = torch.randn((64, 5, 256), generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        out = bf16(x.to(dev, torch.bfloat16))
        ref = f32(x)
    assert out.dtype == torch.bfloat16 and out.shape == (64, 256)
    _bf16_close(out, ref)


def test_tabular_encoder_gate_and_resize_in_bf16_match_float32(dev):
    g = torch.Generator().manual_seed(9)
    x = torch.randn((32, 13), generator=g)
    tab = init_parameters(TabularEncoder(13, 128, 0.0), g).eval()
    gate = init_parameters(DualExpertGate(256, 128, True), g).eval()
    loc, ctx, ent = torch.randn((32, 256), generator=g), torch.randn((32, 256), generator=g), torch.rand((32, 1))
    img = torch.rand((8, 3, 224, 224), generator=g)
    with torch.inference_mode():
        _bf16_close(tab.to(dev, torch.bfloat16)(x.to(dev)), tab.float().cpu()(x))
        alpha = gate.to(dev, torch.bfloat16)(loc.to(dev, torch.bfloat16), ctx.to(dev, torch.bfloat16), ent.to(dev))
        assert alpha.dtype == torch.float32
        _bf16_close(alpha, gate.float().cpu()(loc, ctx, ent))
        _bf16_close(center_crop_resize(img.to(dev, torch.bfloat16), 0.6), center_crop_resize(img, 0.6))


# --------------------------------------------------------------------------- the vmamba fusion
from mdhs_tpu_torch.modules.fusion import VMambaFusion  # noqa: E402


@pytest.mark.parametrize("B", [64, 3])
def test_vmamba_fusion_forward_and_backward_match_the_plain_scan(dev, monkeypatch, B):
    """The vmamba fusion at its served widths (49 layer-4 tokens 256 wide, BERT-base's 768-wide
    text; the scans at D 64, N 16), float32: the forward launches selective_scan twice (the second
    on the tokens reversed along L) and matches the same weights on the plain scan, and the
    backward (the associative scan's VJP of both, the second back through the flip) gives every
    parameter's gradient, each within 1e-4 of its largest entry."""
    kernel = ss.selective_scan
    fusion = init_parameters(VMambaFusion(768, 256, device=dev), torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(B)
    img, txt, w = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
                   for shape in ((B, 49, 256), (B, 16, 768), (B, 256)))
    got = {}
    for which in ("kernel", "plain"):
        with monkeypatch.context() as m:
            if which == "plain":
                m.setattr(mamba_mod._ss, "selective_scan", ss.selective_scan_reference)
            fusion.zero_grad(set_to_none=True)
            n = kernel.launches
            out = fusion(img, txt)
            (out * w).sum().backward()
            torch.cuda.synchronize()
            got[which] = (out.detach(), {k: p.grad for k, p in fusion.named_parameters()}, kernel.launches - n)
    (out, grads, launched), (ref, ref_grads, plain_launched) = got["kernel"], got["plain"]
    assert (launched, plain_launched) == (2, 0)
    _close_f32(out, ref)
    assert set(grads) == set(ref_grads) and all(g is not None for g in grads.values())
    for k in grads:
        _close_f32(grads[k], ref_grads[k])
