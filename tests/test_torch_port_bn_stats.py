"""mdhs_tpu_torch.ops.bn_stats and models.norm.BatchNorm2d against the JAX
package, on the CPU.

The JAX kernel runs in Pallas interpret mode (the test sets
``mdhs_tpu.ops.bn_stats._INTERPRET``, as tests/test_bn_stats.py does). On the
CPU the port's ``bn_stats`` takes its plain two-pass version in the forward
and the JAX package's analytic VJP in the backward; the CUDA kernel is held
against the plain version in tests/test_torch_port_cuda.py.

Tolerances: statistics in float32 over up to 25,088 rows, summed in another
order than XLA's: rtol 1e-5 on mean and variance, with an atol of 1e-6 for
means near zero (the JAX kernel-vs-reference test allows 2e-5 / 1e-4).
Gradients within 1e-5 of the largest. The BatchNorm module against
``TorchBatchNorm``: outputs atol 1e-5 with the switch, 5e-5 without (torch's
own BatchNorm), running statistics atol 1e-6 with rtol 2e-5 (torch's float32
variance, measured 1.0e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdhs_tpu.ops.bn_stats as jbns
from mdhs_tpu.models.norm import TorchBatchNorm
from mdhs_tpu_torch.models.norm import BatchNorm2d
from mdhs_tpu_torch.ops import bn_stats as tbns

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jbns, "_INTERPRET", True)


def _x(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 3.0 + 5.0).astype(dtype)  # an offset mean: where E[x^2] - mu^2 cancels


@pytest.mark.parametrize("shape", [(8, 56, 56, 64), (32, 7, 7, 256), (4, 14, 14, 128), (2, 4, 5, 40)])
def test_bn_stats_matches_jax_kernel_and_reference(interpret, shape):
    x = _x(shape, sum(shape))
    jm, jv = jax.jit(jbns.bn_stats)(jnp.asarray(x))  # the Pallas kernel, interpreted
    rm, rv = jbns.bn_stats_reference(jnp.asarray(x))
    m, v = tbns.bn_stats(torch.from_numpy(x))
    assert m.dtype == v.dtype == torch.float32 and m.shape == v.shape == (shape[-1],)
    for want in ((jm, jv), (rm, rv)):
        np.testing.assert_allclose(m.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)


def test_bn_stats_bf16_input_matches_jax(interpret):
    x32 = _x((16, 16, 16, 128), 1)
    jx = jnp.asarray(x32).astype(jnp.bfloat16)
    tx = torch.from_numpy(x32).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)), tx.float().numpy())  # the same bf16 values
    jm, jv = jax.jit(jbns.bn_stats)(jx)
    m, v = tbns.bn_stats(tx)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_bn_stats_plain_version_is_the_two_pass_reference():
    x = torch.from_numpy(_x((6, 9, 9, 48), 2))
    m, v = tbns.bn_stats_reference(x)
    x64 = x.double().reshape(-1, 48)
    torch.testing.assert_close(m.double(), x64.mean(0), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(v.double(), x64.var(0, unbiased=False), rtol=1e-5, atol=1e-6)


def test_bn_stats_backward_matches_jax_custom_vjp(interpret):
    x = np.random.default_rng(2).normal(size=(32, 8, 8, 64)).astype(np.float32)
    w = np.random.default_rng(3).normal(size=(64,)).astype(np.float32)

    def jloss(x):
        m, v = jbns.bn_stats(x)
        return jnp.sum(w * m) + jnp.sum(jnp.sqrt(v + 1e-5))

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(x)))  # through the custom VJP
    tx = torch.from_numpy(x).requires_grad_()
    m, v = tbns.bn_stats(tx)
    (torch.sum(torch.from_numpy(w) * m) + torch.sum(torch.sqrt(v + 1e-5))).backward()
    scale = float(np.abs(gj).max())
    np.testing.assert_allclose(tx.grad.numpy(), gj, atol=1e-5 * scale, rtol=1e-4)
    # one statistic unused: its gradient is zero, not missing
    tx.grad = None
    tbns.bn_stats(tx)[1].sum().backward()
    assert torch.isfinite(tx.grad).all()


def test_bn_stats_gate():
    assert tbns.supports((32, 112, 112, 64), torch.bfloat16)
    assert tbns.supports((32 * 7 * 7, 2048), torch.float32)
    assert tbns.supports((2, 5, 5, 40), torch.float32)       # the TPU's tiny-tensor and % 64 rules are gone
    assert not tbns.supports((1 << 24, 8), torch.bfloat16)   # row counts must be exact in float32
    assert not tbns.supports((64, 32), torch.float16)
    assert not tbns.supports((64,), torch.float32)


@pytest.mark.parametrize("kernel", [False, True])
def test_batchnorm_matches_torch_batchnorm_of_jax(interpret, kernel):
    """Train mode, with the bn_stats switch and without, against
    mdhs_tpu.models.norm.TorchBatchNorm (JAX kernel on, interpreted, where
    the port's switch is on)."""
    C = 64
    x = _x((16, 32, 32, C), 4) * 0.5  # a shape the JAX gate sends to its kernel
    rng = np.random.default_rng(5)
    scale = rng.uniform(0.8, 1.2, C).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, C).astype(np.float32)
    mean0 = rng.uniform(-0.1, 0.1, C).astype(np.float32)
    var0 = rng.uniform(0.8, 1.2, C).astype(np.float32)

    jbn = TorchBatchNorm(use_running_average=False, dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    # the JAX gate with its switch set as the port's; its multi-device guard
    # would refuse the suite's 8 virtual CPU devices (ROADMAP Queue 3)
    assert jbns.supports(x.shape, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbns, "use_kernel", lambda shape, dtype: kernel and jbns.supports(shape, dtype))
        ref, new = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    bn = BatchNorm2d(C, bn_stats_kernel=kernel).train()
    keys = set(bn.state_dict())
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    before = tbns.bn_stats.launches
    out = bn(xt)
    assert tbns.bn_stats.launches == before  # the CPU never launches the kernel
    # torch's own BatchNorm sums its statistics in float32 in another order than
    # XLA (measured 1.4e-5 on outputs up to 4 in size); the switch's path has
    # the JAX module's formula and statistics within 1e-5
    atol = 1e-5 if kernel else 5e-5
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=atol, rtol=0)
    # running_var takes the unbiased variance (n / (n - 1)), momentum 0.1
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["batch_stats"]["mean"]), atol=1e-6, rtol=2e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["batch_stats"]["var"]), atol=1e-6, rtol=2e-5)
    assert int(bn.num_batches_tracked) == 1
    assert set(bn.state_dict()) == keys == {"weight", "bias", "running_mean", "running_var", "num_batches_tracked"}
    # gradients reach the input and the affine parameters
    out.square().sum().backward()
    assert bn.weight.grad is not None and torch.isfinite(bn.weight.grad).all()


def test_batchnorm_switch_matches_cudnn_path_gradients():
    """The switch changes where the statistics come from, not the function:
    output and input gradients agree with torch's own BatchNorm."""
    x = torch.from_numpy(_x((4, 9, 9, 24), 6)).permute(0, 3, 1, 2).contiguous()
    outs, grads = [], []
    for kernel in (False, True):
        bn = BatchNorm2d(24, bn_stats_kernel=kernel).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        xi = x.clone().requires_grad_()
        y = bn(xi)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        outs.append(y.detach())
        grads.append(xi.grad)
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[1], grads[0], atol=1e-5, rtol=1e-4)


def test_batchnorm_eval_ignores_the_switch():
    bn = BatchNorm2d(8, bn_stats_kernel=True).eval()
    ref = torch.nn.BatchNorm2d(8).eval()
    x = torch.randn(2, 8, 5, 5, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(bn(x), ref(x), atol=0, rtol=0)
    assert int(bn.num_batches_tracked) == 0


def test_mibfnet_switch_reaches_every_batchnorm():
    """MIBFNet(bn_stats_kernel=True) sets the switch on each of ResNet50's 53
    BatchNorms, and its training-mode step is the default model's on the same
    seeded weights (B = 4, 64^2 images, one BERT layer): logits within 2e-4
    and image-tower gradient cosine >= 0.999, as the one-step training parity
    of tests/test_torch_port_train.py; running statistics atol 1e-5, rtol 1e-4."""
    from mdhs_tpu_torch.models.bert import BertConfig
    from mdhs_tpu_torch.models.init import init_parameters
    from mdhs_tpu_torch.models.mibf import MIBFNet

    cfg = BertConfig(vocab_size=128, hidden_size=768, num_hidden_layers=1, num_attention_heads=12,
                     intermediate_size=128, max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
    models = [MIBFNet(7, cfg, bn_stats_kernel=k) for k in (False, True)]
    init_parameters(models[0], torch.Generator().manual_seed(0))
    models[1].load_state_dict(models[0].state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.rand(4, 3, 64, 64, generator=g)
    ids, mask = torch.randint(0, 128, (4, 12), generator=g), torch.ones(4, 12, dtype=torch.int64)
    outs, grads = [], []
    for switch, m in zip((False, True), models):
        norms = [b for b in m.modules() if isinstance(b, BatchNorm2d)]
        assert len(norms) == 53 and all(b.bn_stats_kernel == switch for b in norms)
        out = m.train()(x, ids, mask)
        (out["image_text"].sum() + out["image"].square().sum()).backward()
        outs.append(out)
        grads.append(torch.cat([p.grad.double().flatten() for p in m.image_encoder.parameters()]))
    for k in outs[0]:
        torch.testing.assert_close(outs[1][k], outs[0][k], atol=2e-4, rtol=0)
    assert (grads[0] @ grads[1] / (grads[0].norm() * grads[1].norm())).item() >= 0.999
    for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        if "running" in name:
            torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-4, msg=name)


# --------------------------------------------------------------------------- the kernels' launch plan
# ResNet50's 53 BatchNorm inputs at training batch 32 (224^2 crops), as channels-last
# rows (N * H * W, C): 12 distinct shapes
RESNET50_B32 = [(401408, 64), (100352, 256), (100352, 64), (25088, 512), (100352, 128), (25088, 128),
                (6272, 1024), (25088, 256), (6272, 256), (1568, 2048), (6272, 512), (1568, 512)]
EDGE_SHAPES = [(1, 5), (129, 3), (1000, 40), ((1 << 24) - 1, 8)]
H100_SMS = 132


def test_resnet50_batchnorm_inputs_are_the_planned_shapes():
    from mdhs_tpu_torch.models.resnet import ResNetClassifier

    model = ResNetClassifier("resnet50", num_outputs=768, device="meta").train()
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(lambda _, i: seen.append((i[0].shape[0] * i[0].shape[2] * i[0].shape[3],
                                                                  i[0].shape[1])))
    with torch.no_grad():
        model(torch.empty(32, 3, 224, 224, device="meta"))
    assert len(seen) == 53 and list(dict.fromkeys(seen)) == RESNET50_B32


def _spans(n, size, extent):
    return [(i * size, min(extent, (i + 1) * size)) for i in range(n)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", RESNET50_B32 + EDGE_SHAPES)
def test_plan_covers_fits_and_fills(shape, itemsize):
    R, C = shape
    p = tbns.plan(R, C, itemsize, H100_SMS)
    # every row and every channel in exactly one group, none empty
    for n, size, extent in ((p.row_groups, p.rows, R), (p.col_groups, p.cols, C)):
        spans = _spans(n, size, extent)
        assert spans[0][0] == 0 and spans[-1][1] == extent
        assert all(a < b for a, b in spans) and all(s[1] == t[0] for s, t in zip(spans, spans[1:]))
    vector = (C * itemsize) % 16 == 0
    assert p.vec == (16 // itemsize if vector else 1) and p.cols % p.vec == 0
    assert 1 <= p.cols // p.vec <= tbns.THREADS  # a block's threads hold a group's vectors
    assert p.col_groups == 1 or p.cols * itemsize >= tbns.MIN_SEGMENT  # a group reads 128 B of a row at least
    assert -(-p.row_groups // p.lanes) <= tbns.MAX_PER_LANE  # partials a lane of the last block combines
    assert p.blocks <= tbns.BLOCKS_PER_SM * H100_SMS + p.col_groups  # one wave
    if R * C * itemsize >= H100_SMS * tbns.CHUNK * tbns.THREADS * 16:  # a step's bytes for every SM
        assert p.blocks >= H100_SMS


def test_plan_takes_plain_loads_off_16_byte_rows_or_alignment():
    assert tbns.plan(1568, 2048, 2, H100_SMS, aligned=False).vec == 1
    assert tbns.plan(1000, 36, 2, H100_SMS).vec == 1        # 72-byte rows
    assert tbns.plan(1000, 36, 4, H100_SMS).vec == 4        # 144-byte rows


def _chan(n_a, m_a, q_a, n_b, m_b, q_b):
    """Chan's combine as csrc/bn_stats.cu::chan, elementwise over tensors; n_a or n_b may be 0."""
    n = n_a + n_b
    safe = torch.where(n > 0, n, torch.ones_like(n))
    f = n_b * (1.0 / safe)
    g = n_a * f
    delta = m_b - m_a
    m = torch.where(n_a == 0, m_b, torch.where(n_b == 0, m_a, m_a + delta * f))
    q = torch.where(n_a == 0, q_b, torch.where(n_b == 0, q_a, q_a + q_b + delta * delta * g))
    return n, m, q


def _pairwise(n, m, q):
    """Over dim 1 (U lanes): lane i takes in lane i + h, h the powers of two from the
    largest below U down to 1; lane 0's result."""
    U = n.shape[1]
    h = 1
    while 2 * h < U:
        h *= 2
    n, m, q = n.clone(), m.clone(), q.clone()
    while h >= 1:
        lo, hi = slice(0, min(h, U - h)), slice(h, min(2 * h, U))
        n[:, lo], m[:, lo], q[:, lo] = _chan(n[:, lo], m[:, lo], q[:, lo], n[:, hi], m[:, hi], q[:, hi])
        h //= 2
    return n[:, 0], m[:, 0], q[:, 0]


def _tree(n, m, q, vg):
    """csrc/bn_stats.cu::tree over dim 1 (the Q row lanes): where a warp holds W = 32 / vg
    of them, the W of each warp pairwise first (its shuffles), then the warps' results."""
    G, Q = n.shape[:2]
    W = 32 // vg if vg < 32 and 32 % vg == 0 else 1
    if W > 1:
        split = [t.reshape(G * (Q // W), W, *t.shape[2:]) for t in (n, m, q)]
        n, m, q = (t.reshape(G, Q // W, *t.shape[1:]) for t in _pairwise(*split))
    return _pairwise(n, m, q)


def _emulate(x, p):
    """The kernel's arithmetic in float32 on the CPU: each channel group's blocks
    (rows in groups of p.rows), their lanes' chunks of up to 4 rows a step, each
    chunk two-pass and merged with Chan's combine, the lanes in the tree order, then
    the last block's slices of groups in group order and the tree again."""
    x = x.float()
    R, C = x.shape
    mean, var = torch.empty(C), torch.empty(C)
    G = p.row_groups
    for c0 in range(0, C, p.cols):
        cw = min(p.cols, C - c0)
        Q = tbns.THREADS // (cw // p.vec)
        S = tbns.CHUNK * Q
        xb = torch.zeros(G * p.rows, cw)
        xb[:R] = x[:, c0:c0 + cw]
        xb = xb.view(G, p.rows, cw)
        nr = torch.tensor([min(p.rows, R - g * p.rows) for g in range(G)])
        n, m, q = torch.zeros(G, Q, 1), torch.zeros(G, Q, cw), torch.zeros(G, Q, cw)
        lane = torch.arange(Q)[:, None] + Q * torch.arange(tbns.CHUNK)[None]  # (Q, CHUNK) rows in a stage
        for it in range(-(-p.rows // S)):
            rows = it * S + lane
            valid = (rows[None] < nr[:, None, None]).float()[..., None]  # (G, Q, CHUNK, 1)
            v = xb[:, rows.clamp(max=p.rows - 1)] * valid  # (G, Q, CHUNK, cw)
            k = valid.sum(2)  # (G, Q, 1)
            t = v[:, :, 0] * valid[:, :, 0]
            for i in range(1, tbns.CHUNK):
                t = t + v[:, :, i]
            mb = t * (1.0 / k.clamp(min=1))
            qb = torch.zeros_like(mb)
            for i in range(tbns.CHUNK):
                d = (v[:, :, i] - mb) * valid[:, :, i]
                qb = qb + d * d
            n, m, q = _chan(n, m, q, k, mb, qb)
        bn, bm, bq = _tree(n, m, q, cw // p.vec)  # (G, 1), (G, cw): the blocks' partials
        per = -(-G // Q)
        sn, sm, sq = torch.zeros(1, Q, 1), torch.zeros(1, Q, cw), torch.zeros(1, Q, cw)
        for i in range(per):  # slice s takes groups s * per + i, in order
            h = torch.arange(Q) * per + i
            ok = (h < torch.minimum(torch.arange(Q) * per + per, torch.tensor(G)))[None, :, None]
            hc = h.clamp(max=G - 1)
            sn, sm, sq = _chan(sn, sm, sq, (bn[hc] * ok[0])[None], bm[hc][None], bq[hc][None])
        tn, tm, tq = _tree(sn, sm, sq, cw // p.vec)
        mean[c0:c0 + cw], var[c0:c0 + cw] = tm[0], tq[0] / R
    return mean, var


@pytest.mark.parametrize("shape, dtype, sms", [((8, 56, 56, 64), np.float32, H100_SMS),
                                               ((4, 28, 28, 64), "bf16", H100_SMS),
                                               ((32, 7, 7, 256), np.float32, H100_SMS),
                                               ((32, 14, 14, 512), "bf16", H100_SMS),
                                               ((4, 14, 14, 128), np.float32, 8),
                                               ((2, 4, 5, 40), "bf16", H100_SMS),
                                               ((2, 4, 5, 36), "bf16", H100_SMS)])
def test_kernel_emulation_matches_jax_kernel_and_reference(interpret, shape, dtype, sms):
    """The kernel's chunking and fixed combine order, emulated in float32, against the
    Pallas kernel (interpret mode) and the two-pass statistics of the same values in
    float64: the warps' shuffles over 4 and 2 row lanes (C 64 in bf16 and float32) and
    none, channel groups split for the fill (32, 14, 14, 512), ragged last steps,
    one channel a thread (C 36 in bf16: 72-byte rows), a small card (8 SMs). The
    two-pass reference of the JAX package sums in float32 and is held too where it
    is itself within 1e-5 of float64: at (32, 14, 14, 512) its variance is 2.6e-5
    from it (XLA's float32 sum over 6,272 rows on the CPU), the emulation's 1.7e-7."""
    x = _x(shape, sum(shape))
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bf16" else jnp.asarray(x)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    R, C = tx.numel() // shape[-1], shape[-1]
    p = tbns.plan(R, C, 2 if dtype == "bf16" else 4, sms)
    m, v = _emulate(tx.reshape(R, C), p)
    x64 = tx.reshape(R, C).double()
    truth = (x64.mean(0), x64.var(0, unbiased=False))
    want = [truth, jax.jit(jbns.bn_stats)(jx)]  # the Pallas kernel, interpreted
    ref = [torch.from_numpy(np.array(a)).double() for a in jbns.bn_stats_reference(jx)]
    if all(torch.allclose(a, b, rtol=1e-5, atol=0) for a, b in zip(ref, truth)):
        want.append(ref)
    elif shape != (32, 14, 14, 512):
        raise AssertionError(f"the JAX reference at {shape} is beyond 1e-5 of float64")
    for wm, wv in want:
        np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)


def _bf16_ulp(v):
    """The spacing of bf16 at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v.astype(np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bn_stats_backward_reference_matches_jax_custom_vjp(interpret, dtype):
    rng = np.random.default_rng(7)
    x = _x((16, 14, 14, 64), 8)
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bf16" else jnp.asarray(x)
    dm = rng.normal(size=64).astype(np.float32)
    dv = rng.normal(size=64).astype(np.float32)
    (jm, _), vjp = jax.vjp(jbns.bn_stats, jx)  # the Pallas kernel, interpreted, and its custom VJP
    (gj,) = vjp((jnp.asarray(dm), jnp.asarray(dv)))
    gj = np.asarray(gj.astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = tbns.bn_stats_backward_reference(tx, torch.from_numpy(np.array(jm)), torch.from_numpy(dm),
                                           torch.from_numpy(dv))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, gj, atol=1e-5 * np.abs(gj).max(), rtol=0)
    else:  # one bf16 ulp of the larger of the two
        assert (np.abs(got - gj) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(gj)))).all()
    # the CPU wrapper is the plain version and launches nothing
    n = tbns.bn_stats_backward.launches
    same = tbns.bn_stats_backward(tx, torch.from_numpy(np.array(jm)), torch.from_numpy(dm), torch.from_numpy(dv))
    assert torch.equal(same.float(), torch.from_numpy(got)) and tbns.bn_stats_backward.launches == n
