"""BERT's flash-attention path in the port against the JAX package, on the CPU.

The JAX package's flash path calls the library's Pallas TPU kernel
(``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention``),
which does not lower on the CPU. ``mdhs_tpu/models/bert.py`` imports it
inside the call, so these tests swap the library module's ``flash_attention``
for the library's own plain reference, ``mha_reference_no_custom_vjp`` (the
same masking; JAX differentiates it, where ``mha_reference``'s custom VJP
refuses segment ids). Nothing in ``mdhs_tpu`` changes. The port's wrappers
take their plain versions because the tensors lie on the CPU. Inputs are
made with numpy from a seed.

Tolerances: the plain forward against the library reference, float32 atol
1e-5, bf16 max |d| <= 6e-2 and mean < 5e-3 (the reference rounds its
scores and probabilities to bf16, the port keeps them float32); the plain
backward against ``jax.vjp`` of the reference, max |d| <= 1e-4 * max |ref|;
BERT's every hidden state, pad positions included, atol 2e-4 in float32;
one training step's loss within 1e-4 relative and each parameter's gradient
within 1e-4 * the largest |ref| of all; MIBF-Net logits atol 2e-4, rtol 1e-3 (as
``tests/test_torch_port_models.py``).
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import mibf as jmibf
from mdhs_tpu_torch.core.convert import bert_state_dict_from_jax, mibf_state_dict_from_jax
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import mibf as tmibf
from mdhs_tpu_torch.ops import flash_attention as tfl
from mdhs_tpu_torch.ops import preprocess as tpre
from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer
from test_torch_port_models import _np_tree, _perturb

torch.set_num_threads(2)

TINY = dict(hidden_dropout=0.0, attention_dropout=0.0)  # over BertConfig.tiny(): 2 layers, 64 wide, 4 heads, L 128


def _flash_via_reference(q, k, v, ab=None, segment_ids=None, *, causal=False, sm_scale=1.0, **_):
    return jflash.mha_reference_no_custom_vjp(q, k, v, ab, segment_ids, causal=causal, sm_scale=sm_scale)


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX package's flash path through the library's plain reference."""
    monkeypatch.setattr(jflash, "flash_attention", _flash_via_reference)


def _segments(B, L):
    """Attention masks of the cases the kernels must get right: pads at the
    end, no pads, mostly pads (the real queries' keys all in the first tile),
    and a row whose second segment's keys lie only in the last tile."""
    seg = np.ones((B, L), np.int32)
    seg[0, L - 5:] = 0
    seg[2, 3:] = 0
    seg[3, : L - 10] = 0
    return seg[:B]


def _qkv(rng, B, L, HD):
    return tuple(rng.standard_normal((B, L, HD)).astype(np.float32) for _ in range(3))


def _jheads(a, heads):  # (B, L, HD) -> (B, heads, L, D), the library layout
    B, L, HD = a.shape
    return jnp.asarray(a).reshape(B, L, heads, HD // heads).transpose(0, 2, 1, 3)


def _junheads(a):
    B, H, L, D = a.shape
    return np.asarray(a.transpose(0, 2, 1, 3).reshape(B, L, H * D).astype(jnp.float32))


def _attention_f64(q, k, v, seg, heads, scale):
    """The masked attention in float64 numpy, (B, L, HD): a yardstick independent of both packages."""
    B, L, HD = q.shape
    q, k, v = (np.asarray(a, np.float64).reshape(B, L, heads, HD // heads).transpose(0, 2, 1, 3) for a in (q, k, v))
    s = q @ k.transpose(0, 1, 3, 2) * scale
    s = np.where((seg[:, :, None] == seg[:, None, :])[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True) @ v).transpose(0, 2, 1, 3).reshape(B, L, HD)


@contextlib.contextmanager
def _intra_op_threads(n):
    """torch's intra-op thread count for the block, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _which_side(out, ref, q, k, v, seg, heads, scale):
    """For a failure's message: each side's max |d| from the float64 attention, and the worst element."""
    exact = _attention_f64(q, k, v, seg, heads, scale)
    d = np.abs(out - ref)
    return {"port_vs_f64": float(np.abs(out - exact).max()), "jax_vs_f64": float(np.abs(ref - exact).max()),
            "worst_element": np.unravel_index(d.argmax(), d.shape)}


# --------------------------------------------------------------------------- the op
@pytest.mark.parametrize("entry", ["reference", "wrapper"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256])
def test_flash_forward_matches_the_library_reference(L, dtype, entry):
    B, HD, heads = 4, 64, 4
    rng = np.random.default_rng(L)
    q, k, v = _qkv(rng, B, L, HD)
    seg = _segments(B, L)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (_jheads(a, heads).astype(jdt) for a in (q, k, v))
    ids = jnp.asarray(seg)
    scale = float(HD // heads) ** -0.5
    ref, ref_l, ref_m = jflash.mha_reference_no_custom_vjp(jq, jk, jv, None, jflash.SegmentIds(ids, ids),
                                                           sm_scale=scale, save_residuals=True)
    tq, tk, tv = (torch.tensor(_junheads(a)).to(getattr(torch, dtype)) for a in (jq, jk, jv))
    n = tfl.flash_attention_forward.launches
    fn = tfl.flash_attention_reference if entry == "reference" else tfl.flash_attention_forward
    with _intra_op_threads(1):  # no intra-op worker thread in the comparison (test_worker_thread_rounding...)
        out, m, l = fn(tq, tk, tv, torch.from_numpy(seg), heads, scale, save_stats=True)
    assert tfl.flash_attention_forward.launches == n  # a CPU tensor takes the plain version
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, L, HD)
    assert m.shape == l.shape == (B, heads, L) and m.dtype == l.dtype == torch.float32
    d = np.abs(out.float().numpy() - _junheads(ref))
    if dtype == "float32":
        assert d.max() < 1e-5, (d.max(), _which_side(out.numpy(), _junheads(ref), q, k, v, seg, heads, scale))
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), atol=1e-5, rtol=0)
        np.testing.assert_allclose(l.numpy(), np.asarray(ref_l), atol=0, rtol=1e-5)
    else:
        assert d.max() <= 6e-2 and d.mean() < 5e-3, (d.max(), d.mean())


@pytest.mark.parametrize("threads", [2, 3])
def test_plain_forward_is_the_same_bits_on_any_thread_count(threads):
    """The port's plain forward does not depend on how its rows split over intra-op
    threads: a deviation confined to some batch rows is no rounding of its own."""
    B, HD, heads, L = 4, 64, 4, 128
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(L), B, L, HD))
    seg = torch.from_numpy(_segments(B, L))
    with _intra_op_threads(1):
        one = tfl.flash_attention_reference(q, k, v, seg, heads, 0.25, save_stats=True)
    with _intra_op_threads(threads):
        many = tfl.flash_attention_reference(q, k, v, seg, heads, 0.25, save_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(one, many))


_ROUNDING_PROBE = textwrap.dedent("""
    import ctypes, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    from mdhs_tpu_torch.ops import flash_attention as tfl
    from test_torch_port_flash import _qkv, _segments
    libm = ctypes.CDLL("libm.so.6")
    B, HD, heads, L = 4, 64, 4, 128
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(L), B, L, HD))
    seg = torch.from_numpy(_segments(B, L))
    torch.set_num_threads(1)
    exact = tfl.flash_attention_reference(q, k, v, seg, heads, 0.25)
    torch.set_num_threads(2)
    libm.fesetround(0xC00)             # round toward zero while the worker thread is made:
    torch.ones(1 << 16).exp().sum()    # it keeps the mode, as a new thread keeps its parent's
    libm.fesetround(0)
    out = tfl.flash_attention_reference(q, k, v, seg, heads, 0.25)
    print(" ".join(str(float((out[b] - exact[b]).abs().max())) for b in range(B)))
""")


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="fesetround through glibc's libm")
def test_worker_thread_rounding_moves_only_its_rows():
    """A mechanism that gives the pattern of the one failure of the float32 forward
    above (max |d| 7.97e-5, in one run of the whole suite, not reproduced since):
    its batch row 0 was bit for bit a normal run's, and the error sat in the last
    rows, the rows a second intra-op thread computes. A worker thread whose
    floating-point environment is not round to nearest moves exactly those rows
    (here by about 3.5e-6); the main thread's stay exact. So the comparison above
    runs its port side on one thread."""
    tests = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tests.parent), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", _ROUNDING_PROBE, str(tests)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = [float(x) for x in res.stdout.split()]
    assert rows[0] == rows[1] == 0.0 and min(rows[2:]) > 1e-7, rows


@pytest.mark.parametrize("L", [128, 256])
def test_flash_backward_matches_jax_vjp_of_the_reference(L):
    B, HD, heads = 4, 64, 4
    rng = np.random.default_rng(L + 1)
    q, k, v = _qkv(rng, B, L, HD)
    do = rng.standard_normal((B, L, HD)).astype(np.float32)
    seg = _segments(B, L)
    ids = jnp.asarray(seg)
    scale = float(HD // heads) ** -0.5
    f = lambda a, b, c: jflash.mha_reference_no_custom_vjp(a, b, c, None, jflash.SegmentIds(ids, ids),  # noqa: E731
                                                           sm_scale=scale)
    _, vjp = jax.vjp(f, *(_jheads(a, heads) for a in (q, k, v)))
    refs = [_junheads(g) for g in vjp(_jheads(do, heads))]

    t = [torch.from_numpy(a) for a in (q, k, v)]
    tseg, tdo = torch.from_numpy(seg), torch.from_numpy(do)
    o, m, l = tfl.flash_attention_reference(*t, tseg, heads, scale, save_stats=True)
    plain = tfl.flash_attention_backward_reference(*t, tseg, o, m, l, tdo, heads, scale)
    # the same gradients through the autograd function, whose wrappers take the plain versions here
    leaves = [x.clone().requires_grad_() for x in t]
    counts = [fn.launches for fn in (tfl.flash_attention_bwd_dkv, tfl.flash_attention_bwd_dq)]
    tfl.FlashAttention.apply(*leaves, tseg, heads, scale).backward(tdo)
    assert [fn.launches for fn in (tfl.flash_attention_bwd_dkv, tfl.flash_attention_bwd_dq)] == counts
    for name, p, a, r in zip("qkv", plain, leaves, refs):
        bound = 1e-4 * np.abs(r).max()
        assert np.abs(p.numpy() - r).max() <= bound, (name, np.abs(p.numpy() - r).max(), bound)
        assert np.abs(a.grad.numpy() - r).max() <= bound, name


def test_flash_wrappers_raise_on_other_devices():
    q = torch.empty((1, 128, 64), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stats = torch.empty((1, 4, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfl.flash_attention_forward(q, q, q, seg, 4, 0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        tfl.flash_attention_bwd_dkv(q, q, q, seg, stats, stats, q, stats, 4, 0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        tfl.flash_attention_bwd_dq(q, q, q, seg, q, stats, stats, q, 4, 0.25)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dq_returns_attention_di(dtype):
    """The dQ entry returns (dq, di); its plain version's di is attention_di's,
    bit for bit, and the dK/dV entry on that di gives the plain backward."""
    B, L, HD, heads = 4, 128, 64, 4
    rng = np.random.default_rng(3)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (*_qkv(rng, B, L, HD), rng.standard_normal((B, L, HD)))]
    q, k, v, do = t
    seg = torch.from_numpy(_segments(B, L))
    scale = float(HD // heads) ** -0.5
    o, m, l = tfl.flash_attention_reference(q, k, v, seg, heads, scale, save_stats=True)
    n = tfl.flash_attention_bwd_dq.launches
    dq, di = tfl.flash_attention_bwd_dq(q, k, v, seg, o, m, l, do, heads, scale)
    assert tfl.flash_attention_bwd_dq.launches == n  # a CPU tensor takes the plain version
    assert di.dtype == torch.float32 and di.shape == (B, heads, L)
    assert torch.equal(di, tfl.attention_di(o, do, heads))
    dk, dv = tfl.flash_attention_bwd_dkv(q, k, v, seg, m, l, do, di, heads, scale)
    for a, b in zip((dq, dk, dv), tfl.flash_attention_backward_reference(q, k, v, seg, o, m, l, do, heads, scale)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("args, ok", [
    ((torch.bfloat16, 512, 768, 12), True),   # BERT-base at seq 512
    ((torch.bfloat16, 200, 768, 12), True),   # ragged L: the 128-multiple is BERT's gate, not the kernels'
    ((torch.bfloat16, 1, 768, 12), True),
    ((torch.bfloat16, 4096, 768, 12), True),  # no bound on L: both sides stream in tiles
    ((torch.bfloat16, 512, 256, 8), True),    # head_dim 32
    ((torch.bfloat16, 512, 512, 4), True),    # head_dim 128
    ((torch.bfloat16, 512, 1024, 4), False),  # head_dim 256: more accumulators than a warp holds
    ((torch.bfloat16, 512, 384, 32), False),  # head_dim 12 is not a multiple of 8
    ((torch.bfloat16, 512, 768, 10), False),  # 768 % 10 != 0
    ((torch.bfloat16, 0, 768, 12), False),
    ((torch.float32, 512, 768, 12), False),
])
def test_flash_supports(args, ok):
    assert tfl.supports(*args) is ok


# --------------------------------------------------------------------------- BERT
def _bert_inputs(B=3, L=128, seed=5, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[1, L - 27:] = 0   # pads in the last tile
    mask[2, 5:] = 0        # mostly pads
    return ids, mask


@pytest.fixture(scope="module")
def bert_pair():
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), **TINY)
    jmodel = jbert.BertModel(jbert.BertConfig(**dataclasses.asdict(cfg)), dtype=jnp.float32)
    ids, mask = _bert_inputs()
    var = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    params, _ = _perturb(_np_tree(var["params"]), {}, seed=4)
    return cfg, params


def _jax_bert(cfg, impl):
    return jbert.BertModel(jbert.BertConfig(**{**dataclasses.asdict(cfg), "attention_impl": impl}), dtype=jnp.float32)


def _port_bert(cfg, params, impl, **kw):
    model = tbert.BertModel(dataclasses.replace(cfg, attention_impl=impl, **kw))
    model.load_state_dict(bert_state_dict_from_jax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_bert_every_hidden_state_matches_jax(jax_flash, bert_pair, impl):
    """Pad positions included: under flash a pad query attends to the pad
    keys only (docs/PARITY.md:19), in the port as in the JAX package."""
    cfg, params = bert_pair
    ids, mask = _bert_inputs()
    _, ref_all = _jax_bert(cfg, impl).apply({"params": params}, jnp.asarray(ids, jnp.int32),
                                            jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        _, hidden = _port_bert(cfg, params, impl)(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(hidden) == len(ref_all) == cfg.num_hidden_layers + 1
    for i, (h, r) in enumerate(zip(hidden, ref_all)):
        np.testing.assert_allclose(h.numpy(), np.asarray(r), atol=2e-4, rtol=0, err_msg=f"hidden {i}")


def test_bert_flash_pad_rows_differ_from_the_plain_path(bert_pair):
    """The check above would pass a kernel that masks like the plain path
    only if the two agreed at pad positions: they do not, and real rows do."""
    cfg, params = bert_pair
    ids, mask = (torch.from_numpy(a) for a in _bert_inputs())
    with torch.no_grad():
        flash = _port_bert(cfg, params, "flash")(ids, mask)[0]
        plain = _port_bert(cfg, params, "xla")(ids, mask)[0]
    real = mask.bool()
    d = (flash - plain).abs()
    assert d[real].max() < 1e-4 and d[~real].max() > 1e-2


def test_bert_xla_is_the_plain_path(bert_pair, monkeypatch):
    """The module path has one name, the JAX one ("xla"): no kernel wrapper
    is reached, and the output is "auto"'s on the CPU, bit for bit."""
    cfg, params = bert_pair
    ids, mask = (torch.from_numpy(a) for a in _bert_inputs())
    with pytest.raises(ValueError, match="attention_impl='plain'"):
        tbert.BertModel(dataclasses.replace(cfg, attention_impl="plain"))
    with torch.no_grad():
        auto = _port_bert(cfg, params, "auto")(ids, mask)[1]
        monkeypatch.setattr(tfl, "flash_attention", lambda *a: pytest.fail("flash core under xla"))
        monkeypatch.setattr(tbert._fa, "fused_attention", lambda *a: pytest.fail("fused core under xla"))
        xla = _port_bert(cfg, params, "xla")(ids, mask)[1]
    for a, b in zip(auto, xla):
        assert torch.equal(a, b)


def _bert_loss(hidden, w):
    return (hidden * w).sum() / hidden.shape[0]


def test_bert_flash_training_step_gradients_match_jax(jax_flash, bert_pair):
    """One step in training mode with dropout 0 (the flash gate's training
    case): the loss reads every position, pads included."""
    cfg, params = bert_pair
    ids, mask = _bert_inputs(seed=6)
    w = np.random.default_rng(7).standard_normal((3, 128, cfg.hidden_size)).astype(np.float32)
    jmodel = _jax_bert(cfg, "flash")

    def loss_fn(p):
        last, _ = jmodel.apply({"params": p}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
                               deterministic=False)
        return _bert_loss(last, jnp.asarray(w))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    model = _port_bert(cfg, params, "flash").train()
    counts = [fn.launches for fn in (tfl.flash_attention_forward, tfl.flash_attention_bwd_dkv,
                                     tfl.flash_attention_bwd_dq)]
    calls = []
    orig = tfl.FlashAttention.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfl.FlashAttention, "apply", lambda *a: calls.append(1) or orig(*a))
        loss = _bert_loss(model(torch.from_numpy(ids), torch.from_numpy(mask))[0], torch.from_numpy(w))
    loss.backward()
    assert len(calls) == cfg.num_hidden_layers  # the autograd function, with its backward wrappers
    assert counts == [fn.launches for fn in (tfl.flash_attention_forward, tfl.flash_attention_bwd_dkv,
                                             tfl.flash_attention_bwd_dq)]
    assert abs(loss.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    ref = bert_state_dict_from_jax(_np_tree(grads_j))
    # one bound for all: the key bias's gradient is 0 up to rounding (softmax ignores a per-row shift)
    bound = 1e-4 * max(r.abs().max().item() for r in ref.values())
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert (g - ref[name]).abs().max().item() <= bound, name


def test_bert_flash_gate_needs_a_multiple_of_128(bert_pair, monkeypatch):
    """At L = 96 the flash configuration is the plain path, bit for bit, as in JAX."""
    cfg, params = bert_pair
    ids, mask = (torch.from_numpy(a) for a in _bert_inputs(L=96))
    monkeypatch.setattr(tfl, "flash_attention", lambda *a: pytest.fail("flash core at L = 96"))
    with torch.no_grad():
        outs = [_port_bert(cfg, params, impl)(ids, mask)[1] for impl in ("flash", "xla")]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_bert_int8_in_eval_comes_before_flash(bert_pair, monkeypatch):
    cfg, params = bert_pair
    ids, mask = (torch.from_numpy(a) for a in _bert_inputs())
    with torch.no_grad():
        auto = _port_bert(cfg, params, "auto", quantize="int8")(ids, mask)[1]
        monkeypatch.setattr(tfl, "flash_attention", lambda *a: pytest.fail("flash core under int8 in eval"))
        flash = _port_bert(cfg, params, "flash", quantize="int8")(ids, mask)[1]
    for a, b in zip(auto, flash):
        assert torch.equal(a, b)


def test_bert_int8_is_ignored_in_flash_training(bert_pair):
    cfg, params = bert_pair
    ids, mask = (torch.from_numpy(a) for a in _bert_inputs())
    outs = [_port_bert(cfg, params, "flash", quantize=q).train()(ids, mask)[0] for q in ("none", "int8")]
    assert torch.equal(outs[0], outs[1])


def test_bert_flash_training_with_attention_dropout_takes_the_plain_path(bert_pair, monkeypatch):
    cfg, params = bert_pair
    ids, mask = (torch.from_numpy(a) for a in _bert_inputs())
    monkeypatch.setattr(tfl, "flash_attention", lambda *a: pytest.fail("flash core with attention dropout"))
    outs = []
    for impl in ("flash", "xla"):
        model = _port_bert(cfg, params, impl, attention_dropout=0.1).train()
        torch.manual_seed(0)  # the same dropout masks on both paths
        outs.append(model(ids, mask)[0])
    assert torch.equal(outs[0], outs[1])


def test_flash_parameter_tree_is_every_impls(jax_flash, bert_pair):
    """The converter needs nothing new: the JAX tree and the port's
    state_dict are the same under every attention_impl."""
    cfg, params = bert_pair
    ids, mask = _bert_inputs()
    trees = [_jax_bert(cfg, impl).init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(mask, jnp.int32))["params"] for impl in ("auto", "flash", "xla")]
    shapes = [jax.tree_util.tree_map(jnp.shape, t) for t in trees]
    assert shapes[0] == shapes[1] == shapes[2]
    keys = [{k: tuple(v.shape) for k, v in tbert.BertModel(dataclasses.replace(cfg, attention_impl=impl))
             .state_dict().items()} for impl in ("auto", "flash", "xla")]
    assert keys[0] == keys[1] == keys[2] == {k: tuple(v.shape) for k, v in bert_state_dict_from_jax(params).items()}


# --------------------------------------------------------------------------- MIBF-Net
# the widths of tests/test_full_model_parity.py::test_mibf_full_model_logit_parity, at seq 128
MIBF_BERT = dict(vocab_size=128, hidden_size=768, num_hidden_layers=1, num_attention_heads=12,
                 intermediate_size=128, max_position_embeddings=128, hidden_dropout=0.0, attention_dropout=0.0)


def test_mibf_flash_matches_jax(jax_flash):
    B, S, L, LABELS = 2, 64, 128, 6
    rng = np.random.default_rng(8)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    ids = rng.integers(0, 128, (B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[1, 40:] = 0
    jcfg = jbert.BertConfig(**MIBF_BERT, attention_impl="flash")
    model = jmibf.MIBFNet(num_labels=LABELS, bert=jcfg, dtype=jnp.float32)
    args = (jnp.asarray(img), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    var = jax.jit(model.init)(jax.random.PRNGKey(0), *args)
    params, stats = _perturb(_np_tree(var["params"]), _np_tree(var["batch_stats"]), seed=9)
    ref = jax.jit(model.apply)({"params": params, "batch_stats": stats}, *args)
    port = tmibf.MIBFNet(LABELS, tbert.BertConfig(**MIBF_BERT, attention_impl="flash")).eval()
    port.load_state_dict(mibf_state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))), torch.from_numpy(ids),
                   torch.from_numpy(mask))
    for key in ("image_text", "text", "image"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=2e-4, rtol=1e-3, err_msg=key)


def test_trainer_runs_a_flash_preset():
    """A training step goes through the flash autograd function (the three
    wrappers once a layer), validation through the forward alone."""
    bert = tbert.BertConfig(vocab_size=64, num_hidden_layers=2, intermediate_size=64, max_position_embeddings=128,
                            attention_impl="flash", attention_dropout=0.0)
    preset = dataclasses.replace(MIBF_HAM_TRAIN, bert=bert, batch_size=2, seq_len=128, canvas=40, image_size=32,
                                 precision="f32")
    trainer = Trainer(preset, device="cpu")
    rng = np.random.default_rng(0)
    mask = np.ones((2, 128), np.int64)
    mask[1, 70:] = 0
    batch = {"image": rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8),
             "input_ids": rng.integers(0, 64, (2, 128)), "attention_mask": mask, "label": np.array([1, 4])}
    calls = {"forward": 0, "dkv": 0, "dq": 0}

    def spy(key, fn):
        return lambda *a, **kw: calls.__setitem__(key, calls[key] + 1) or fn(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        for key in calls:
            name = "flash_attention_forward" if key == "forward" else f"flash_attention_bwd_{key}"
            mp.setattr(tfl, name, spy(key, getattr(tfl, name)))
        assert np.isfinite(float(trainer.train_step(batch)["loss"]))
        assert calls == {"forward": 2, "dkv": 2, "dq": 2}
        loss, _ = trainer.validate([batch])
        assert np.isfinite(loss) and calls == {"forward": 4, "dkv": 2, "dq": 2}


# --------------------------------------------------------------------------- the repaired faults
@pytest.mark.parametrize("head_dim", [16, 12, 64, 40, 48, 24])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fast_math_scale_is_jax_division(head_dim, dtype):
    """The fast_math scale, made once as a buffer, divides as JAX's
    ``scores / jnp.asarray(head_dim**0.5, dtype)``, bit for bit."""
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), hidden_size=4 * head_dim, fast_math=True)
    tdt = getattr(torch, dtype)
    att = tbert.BertSelfAttention(cfg, dtype=tdt)
    assert "head_scale" not in att.state_dict()
    scores = np.random.default_rng(head_dim).standard_normal((2, 4, 8, 8)).astype(np.float32) * 10
    jdt = getattr(jnp, dtype)
    ref = np.asarray((jnp.asarray(scores).astype(jdt) / jnp.asarray(head_dim**0.5, jdt)).astype(jnp.float32))
    got = (torch.from_numpy(scores).to(tdt) / att.head_scale.to(tdt)).float().numpy()
    np.testing.assert_array_equal(got, ref)


def test_fast_math_attention_matches_jax_in_float32(bert_pair):
    cfg, params = bert_pair
    ids, mask = _bert_inputs()
    jcfg = {**dataclasses.asdict(cfg), "fast_math": True, "attention_impl": "xla"}
    _, ref_all = jbert.BertModel(jbert.BertConfig(**jcfg), dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        _, hidden = _port_bert(cfg, params, "xla", fast_math=True)(torch.from_numpy(ids), torch.from_numpy(mask))
    for h, r in zip(hidden, ref_all):
        np.testing.assert_allclose(h.numpy(), np.asarray(r), atol=2e-4, rtol=0)


def test_imagenet_normalization_is_made_once_per_device():
    x = torch.from_numpy(np.random.default_rng(0).random((2, 5, 5, 3)).astype(np.float32))
    mean = torch.tensor(tpre.IMAGENET_MEAN, dtype=torch.float32)
    std = torch.tensor(tpre.IMAGENET_STD, dtype=torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(tpre.normalize_imagenet(x, dtype), ((x - mean) / std).to(dtype))
    with torch.inference_mode():
        y = tpre.normalize_imagenet(x, torch.float32)
    assert tpre.imagenet_stats(x.device) is tpre.imagenet_stats(x.device)
    assert not tpre.imagenet_stats(x.device)[0].is_inference()
    assert torch.equal(y, ((x - mean) / std))
