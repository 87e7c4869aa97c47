"""The selective scan, MambaBlock and the SSM fusion of mdhs_tpu_torch against
the JAX package, on the CPU in float32.

``selective_scan``'s plain version (what a CPU tensor takes) is held against
the JAX reference ``selective_scan_ref`` (an associative scan) and against
the Pallas TPU kernel ``_selective_scan_tpu`` itself, run in interpret mode:
the test swaps ``pallas_call`` for ``functools.partial(pallas_call,
interpret=True)`` for the call; the JAX package is not edited. Tolerance:
max |d| <= 1e-5 * max |ref| (float32, sums in another order). The modules
carry their weights across from the JAX ``init`` with every bias, ``A_log``,
``dt_bias`` and ``D`` moved off its init value; atol 2e-5 on outputs of
order 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mdhs_tpu.modules import fusion as jfusion
from mdhs_tpu.modules import mamba as jmamba
from mdhs_tpu.ops import selective_scan as jss
from mdhs_tpu_torch.core.convert import mamba_state_dict_from_jax
from mdhs_tpu_torch.modules import fusion as tfusion
from mdhs_tpu_torch.modules import mamba as tmamba
from mdhs_tpu_torch.ops import selective_scan as tss

torch.set_num_threads(2)


def scan_inputs(B, L, D, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, D)))).astype(np.float32)  # softplus: positive steps
    A = -np.exp(rng.standard_normal((D, N))).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    Ds = rng.standard_normal(D).astype(np.float32)
    return x, dt, A, Bm, Cm, Ds


def _close(out, ref, frac=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    d = np.abs(out - ref).max()
    assert d <= frac * np.abs(ref).max(), (d, np.abs(ref).max())


def _port_scan(inputs):
    return tss.selective_scan(*(torch.from_numpy(a) for a in inputs)).numpy()


@pytest.mark.parametrize("B, L, D, N", [(2, 49, 200, 16), (3, 12, 8, 4), (2, 30, 72, 8), (1, 7, 16, 128)])
def test_plain_scan_matches_the_jax_reference(B, L, D, N):
    inputs = scan_inputs(B, L, D, N, seed=L + N)
    _close(_port_scan(inputs), jss.selective_scan_ref(*map(jnp.asarray, inputs)))


@pytest.mark.parametrize("B, L, D, N", [(2, 49, 200, 16), (2, 30, 72, 8)])
def test_plain_scan_matches_the_pallas_kernel_in_interpret_mode(monkeypatch, B, L, D, N):
    """D = 200 and 72 exercise the TPU kernel's channel padding to 128-lane blocks."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    inputs = scan_inputs(B, L, D, N, seed=D)
    ref = jss._selective_scan_tpu(*map(jnp.asarray, inputs))
    _close(_port_scan(inputs), ref)


def test_scan_wrapper_takes_the_plain_version_on_the_cpu():
    inputs = [torch.from_numpy(a) for a in scan_inputs(2, 5, 8, 16, seed=0)]
    n = tss.selective_scan.launches
    torch.testing.assert_close(tss.selective_scan(*inputs), tss.selective_scan_reference(*inputs), atol=0, rtol=0)
    assert tss.selective_scan.launches == n


@pytest.mark.parametrize("shape, N, dtype, ok", [
    ((64, 49, 512), 16, torch.float32, True), ((64, 196, 320), 8, torch.float32, True),
    ((16, 64, 512), 128, torch.float32, True), ((1, 1, 1), 1, torch.float32, True),
    ((2, 8, 8), 129, torch.float32, False), ((2, 8, 8), 16, torch.bfloat16, False),
    ((70000, 8, 8), 16, torch.float32, False), ((8, 8), 16, torch.float32, False),
])
def test_scan_gate(shape, N, dtype, ok):
    assert tss.supports(shape, N, dtype) is ok


def _perturb(tree, seed):
    """Move biases, A_log, dt_bias and D off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("bias", "conv1d_bias", "dt_bias"):
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name == "A_log":
            return (a + rng.uniform(-0.3, 0.3, a.shape)).astype(np.float32)
        if name == "D":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def mamba_pair():
    d_model = 32
    u = np.random.default_rng(1).standard_normal((3, 11, d_model)).astype(np.float32)
    jmod = jmamba.MambaBlock(d_model=d_model, dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(u))["params"], seed=2)
    mod = tmamba.MambaBlock(d_model)
    mod.load_state_dict(mamba_state_dict_from_jax(params), strict=True)
    return jmod, params, mod, u


def test_mamba_block_matches_jax(mamba_pair):
    jmod, params, mod, u = mamba_pair
    ref = jmod.apply({"params": params}, jnp.asarray(u))
    with torch.no_grad():
        out = mod(torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_mamba_block_shapes_follow_the_jax_module(mamba_pair):
    _, params, mod, _ = mamba_pair
    assert (mod.d_inner, mod.d_state, mod.d_conv, mod.dt_rank) == (64, 16, 4, 2)
    assert tuple(mod.conv1d.weight.shape) == (64, 1, 4) and params["conv1d_weight"].shape == (4, 1, 64)
    assert tuple(mod.A_log.shape) == params["A_log"].shape == (64, 16)
    assert mod.dt_proj.bias is None


def test_ssm_fusion_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 9, 32)).astype(np.float32)
    txt = rng.standard_normal((2, 6, 24)).astype(np.float32)
    mask = np.ones((2, 6), np.int32)
    jmod = jfusion.SSMFusion(text_dim=24, hidden_dim=32, dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(4), jnp.asarray(img), jnp.asarray(txt), jnp.asarray(mask))["params"],
                      seed=5)
    ref = jmod.apply({"params": params}, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(mask))
    mod = tfusion.SSMFusion(24, 32)
    sd = mamba_state_dict_from_jax(params["mamba"], "mamba.")
    sd["txt_proj.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(params["txt_proj"]["kernel"]).T))
    sd["txt_proj.bias"] = torch.from_numpy(np.asarray(params["txt_proj"]["bias"]))
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(mask))
    assert out.shape == (2, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="single-scale"):
        mod(dict.fromkeys(("layer2", "layer3", "layer4"), torch.from_numpy(img)), torch.from_numpy(txt))


def test_mamba_float32_islands_in_a_bf16_block():
    mod = tmamba.MambaBlock(32, dtype=torch.bfloat16)
    assert mod.in_proj.weight.dtype == mod.conv1d.weight.dtype == mod.out_proj.weight.dtype == torch.bfloat16
    assert mod.dt_bias.dtype == mod.A_log.dtype == mod.D.dtype == torch.float32
    from mdhs_tpu_torch.models.init import init_parameters

    init_parameters(mod, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = mod(torch.randn((2, 5, 32), dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_mamba_init_follows_the_jax_init():
    from mdhs_tpu_torch.models.init import init_parameters

    mod = init_parameters(tmamba.MambaBlock(32), torch.Generator().manual_seed(0))
    u = jnp.zeros((1, 4, 32))
    ref = jmamba.MambaBlock(d_model=32, dtype=jnp.float32).init(jax.random.PRNGKey(0), u)["params"]
    np.testing.assert_array_equal(mod.A_log.detach().numpy(), np.asarray(ref["A_log"]))
    np.testing.assert_array_equal(mod.D.detach().numpy(), np.asarray(ref["D"]))
    dt = torch.nn.functional.softplus(mod.dt_bias.detach())
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 1e-1 * 1.001
