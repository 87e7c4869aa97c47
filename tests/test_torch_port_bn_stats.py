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
