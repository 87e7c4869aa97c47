"""KAN layers, the kan_forward kernel's plain version, the MoE gating, the MoE
bank and the MoE head of mdhs_tpu_torch against the JAX package, on the CPU
in float32.

``kan_forward``'s plain version (what a CPU tensor takes) is held against
the JAX reference ``kan_forward_ref`` and against the Pallas TPU kernel
``_kan_forward_pallas`` itself in interpret mode (``pallas_call`` swapped for
``functools.partial(pallas_call, interpret=True)`` for the call; the JAX
package is not edited): max |d| <= 1e-5 * max |ref| (float32 sums in another
order). Modules carry their weights across from the JAX ``init`` with the
spline scalers and ``w_gate`` moved off their init values; ``w_gate`` is
drawn so that rows route to different experts (zero, every probability
ties). atol 2e-5 on outputs of order 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mdhs_tpu.modules import heads as jheads
from mdhs_tpu.modules import kan as jkan
from mdhs_tpu.modules import moe as jmoe
from mdhs_tpu.ops import kan_spline as jks
from mdhs_tpu_torch.core.convert import moe_state_dict_from_jax
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.modules import heads as theads
from mdhs_tpu_torch.modules import kan as tkan
from mdhs_tpu_torch.modules import moe as tmoe
from mdhs_tpu_torch.ops import kan_spline as tks

torch.set_num_threads(2)
T = torch.from_numpy


def _close(out, ref, frac=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    d = np.abs(out - ref).max()
    assert d <= frac * np.abs(ref).max(), (d, np.abs(ref).max())


def kan_inputs(B, IN, OUT, seed, E=None):
    rng = np.random.default_rng(seed)
    lead = () if E is None else (E,)
    x = (rng.standard_normal(lead + (B, IN)) * 0.7).astype(np.float32)
    x.flat[:IN] = np.linspace(-1.6, 1.6, IN)  # on and between the knots, and outside the grid
    grid = np.asarray(jkan.make_grid(IN, 5, 3))
    grid = np.broadcast_to(grid, lead + grid.shape).copy()
    bw = (rng.standard_normal(lead + (OUT, IN)) * 0.1).astype(np.float32)
    sw = (rng.standard_normal(lead + (OUT, IN, 8)) * 0.1).astype(np.float32)
    return x, grid, bw, sw


def test_make_grid_is_the_jax_grid():
    for args in ((7, 5, 3), (3, 8, 3, (-4.0, 4.0))):
        np.testing.assert_array_equal(tkan.make_grid(*args).numpy(), np.asarray(jkan.make_grid(*args)))


def test_b_splines_match_jax():
    x, grid, _, _ = kan_inputs(33, 20, 1, seed=0)
    _close(tks.b_splines(T(x), T(grid), 3).numpy(), jkan.b_splines(jnp.asarray(x), jnp.asarray(grid), 3))


@pytest.mark.parametrize("B, IN, OUT", [(40, 64, 200), (64, 96, 40), (3, 5, 7)])
def test_plain_kan_forward_matches_the_jax_reference(B, IN, OUT):
    x, grid, bw, sw = kan_inputs(B, IN, OUT, seed=B + IN)
    ref = jks.kan_forward_ref(*map(jnp.asarray, (x, grid, bw, sw)), 3)
    _close(tks.kan_forward(T(x), T(grid), T(bw), T(sw)).numpy(), ref)


def test_plain_kan_forward_matches_the_pallas_kernel_in_interpret_mode(monkeypatch):
    """B = 40 and OUT = 200 exercise the TPU kernel's padding to 128-row and 128-column tiles."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    x, grid, bw, sw = kan_inputs(40, 64, 200, seed=1)
    ref = jks._kan_forward_pallas(*map(jnp.asarray, (x, grid, bw, sw)), 3)
    _close(tks.kan_forward(T(x), T(grid), T(bw), T(sw)).numpy(), ref)


@pytest.mark.parametrize("shared", [True, False])
def test_bank_matches_the_jax_reference_per_expert(shared):
    E, B, IN, OUT = 3, 10, 16, 9
    x, grid, bw, sw = kan_inputs(B, IN, OUT, seed=2, E=E)
    xs = x[0] if shared else x
    out = tks.kan_forward(T(np.ascontiguousarray(xs)), T(grid), T(bw), T(sw)).numpy()
    assert out.shape == (E, B, OUT)
    for e in range(E):
        ref = jks.kan_forward_ref(jnp.asarray(x[0] if shared else x[e]), jnp.asarray(grid[e]),
                                  jnp.asarray(bw[e]), jnp.asarray(sw[e]), 3)
        _close(out[e], ref)


def test_kan_wrapper_takes_the_plain_version_on_the_cpu():
    args = [T(a) for a in kan_inputs(4, 6, 5, seed=3)]
    n = tks.kan_forward.launches
    torch.testing.assert_close(tks.kan_forward(*args), tks.kan_forward_reference(*args), atol=0, rtol=0)
    assert tks.kan_forward.launches == n


@pytest.mark.parametrize("x, grid, base, order, dtype, ok", [
    ((64, 256), (4, 256, 12), (4, 1024, 256), 3, torch.float32, True),
    ((4, 64, 1024), (4, 1024, 12), (4, 7, 1024), 3, torch.float32, True),
    ((5, 3), (3, 12), (7, 3), 3, torch.float32, True),
    ((5, 3), (3, 14), (7, 3), 4, torch.float32, False),  # another spline order
    ((5, 3), (3, 15), (7, 3), 3, torch.float32, False),  # another grid size
    ((5, 3), (3, 12), (7, 3), 3, torch.bfloat16, False),
])
def test_kan_gate(x, grid, base, order, dtype, ok):
    assert tks.supports(x, grid, base, order, dtype) is ok


def _perturb(tree, seed):
    """Move the spline scalers and biases off their init values and draw w_gate."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name == "spline_scaler":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if name == "bias":
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name == "w_gate":
            return rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _kan_linear_sd(params, grid, prefix=""):
    sd = {f"{prefix}{k}": T(np.array(v)) for k, v in params.items()}
    sd[f"{prefix}grid"] = T(np.array(grid))
    return sd


def test_kan_linear_and_stack_match_jax():
    x = (np.random.default_rng(4).standard_normal((2, 5, 12)) * 0.8).astype(np.float32)
    jstack = jkan.KAN(layers_hidden=(12, 20, 6), dtype=jnp.float32)
    var = jstack.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, state = _perturb(var["params"], 5), var["kan_state"]
    ref = jstack.apply({"params": params, "kan_state": state}, jnp.asarray(x))
    stack = tkan.KAN((12, 20, 6))
    sd = {}
    for i in range(2):
        sd.update(_kan_linear_sd(params[f"layer_{i}"], state[f"layer_{i}"]["grid"], f"layers.{i}."))
    stack.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = stack(T(x))
        one = stack.layers[0](T(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    ref_one = jkan.KANLinear(12, 20, dtype=jnp.float32).apply(
        {"params": params["layer_0"], "kan_state": state["layer_0"]}, jnp.asarray(x))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref_one), atol=2e-5, rtol=0)


def test_cv_squared_matches_jax():
    for v in (np.array([3.0, 1.0, 0.0, 2.0], np.float32), np.array([5.0], np.float32)):
        np.testing.assert_allclose(tmoe.cv_squared(T(v)).numpy(), np.asarray(jmoe.cv_squared(jnp.asarray(v))),
                                   rtol=1e-6)


@pytest.mark.parametrize("w_scale", [1.0, 0.0])
def test_eval_gating_matches_jax(w_scale):
    """w_scale 0: every probability ties, and both take the lowest indices."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((9, 16)).astype(np.float32)
    w_gate = (rng.standard_normal((16, 4)) * w_scale).astype(np.float32)
    w_noise = rng.standard_normal((16, 4)).astype(np.float32)
    gates, load = tmoe.noisy_top_k_gating(T(x), T(w_gate), T(w_noise), 2)
    jg, jl = jmoe.noisy_top_k_gating(jnp.asarray(x), jnp.asarray(w_gate), jnp.asarray(w_noise), 2, train=False)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jl))
    if w_scale:
        assert len({tuple(r) for r in (gates.numpy() > 0)}) > 1  # rows route differently
    # training with no generator and no noise takes the clean branch, as JAX's with no rng
    tg, tl = tmoe.noisy_top_k_gating(T(x), T(w_gate), T(w_noise), 2, train=True)
    jg, jl = jmoe.noisy_top_k_gating(jnp.asarray(x), jnp.asarray(w_gate), jnp.asarray(w_noise), 2, train=True)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.fixture(scope="module")
def moe_pair():
    x = (np.random.default_rng(7).standard_normal((6, 16)) * 0.8).astype(np.float32)
    jmod = jmoe.MoE(input_size=16, output_size=7, num_experts=4, k=2, expert_layers=(16, 24, 7), dtype=jnp.float32)
    var = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params, state = _perturb(var["params"], 8), var["kan_state"]
    mod = tmoe.MoE(16, 7, 4, 2, expert_layers=(16, 24, 7))
    mod.load_state_dict(moe_state_dict_from_jax(params, state), strict=True)
    return jmod, params, state, mod, x


def test_moe_logits_and_balance_match_jax(moe_pair):
    jmod, params, state, mod, x = moe_pair
    ref, ref_balance = jmod.apply({"params": params, "kan_state": state}, jnp.asarray(x))
    with torch.no_grad():
        out, balance = mod(T(x))
    assert out.dtype == torch.float32 and out.shape == (6, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(balance.numpy(), np.asarray(ref_balance), rtol=1e-5)


def test_moe_bank_matches_each_expert_alone(moe_pair):
    *_, mod, x = moe_pair
    with torch.no_grad():
        bank = mod.expert_bank(T(x))
        for e, expert in enumerate(mod.experts):
            torch.testing.assert_close(bank[e], expert(T(x)), atol=1e-6, rtol=0)


def test_moe_head_matches_jax(moe_pair):
    _, params, state, _, x = moe_pair
    jhead = jheads.MoEHead(hidden_dim=16, num_classes=7, dropout=0.1, num_experts=4, k=2, dtype=jnp.float32)
    var = jhead.init(jax.random.PRNGKey(2), jnp.asarray(x))
    hp, hs = _perturb(var["params"], 9), var["kan_state"]
    ref = jhead.apply({"params": hp, "kan_state": hs}, jnp.asarray(x))
    head = theads.MoEHead(16, 7, dropout=0.1, num_experts=4, k=2).eval()
    head.load_state_dict(moe_state_dict_from_jax(hp["moe"], hs["moe"], "moe."), strict=True)
    assert [tuple(layer.base_weight.shape) for layer in head.moe.experts[0].layers] == [(64, 16), (7, 64)]
    with torch.no_grad():
        out = head(T(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="generator"):  # in training the gating noise needs its generator
        head.train()(T(x))


def test_kan_float32_islands_in_a_bf16_module():
    mod = init_parameters(tmoe.MoE(16, 7, 4, 2, expert_layers=(16, 24, 7), dtype=torch.bfloat16),
                          torch.Generator().manual_seed(0))
    layer = mod.experts[0].layers[0]
    assert all(t.dtype == torch.float32 for t in (layer.grid, layer.base_weight, layer.spline_weight,
                                                  layer.spline_scaler, mod.w_gate, mod.w_noise))
    np.testing.assert_array_equal(layer.grid.numpy(), np.asarray(jkan.make_grid(16, 5, 3)))
    assert layer(torch.zeros((2, 16), dtype=torch.bfloat16)).dtype == torch.bfloat16
    out, _ = mod(torch.randn((3, 16)).to(torch.bfloat16))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@torch.no_grad()
def test_kan_init_bounds():
    layer = init_parameters(tkan.KANLinear(64, 10), torch.Generator().manual_seed(1))
    assert float(layer.base_weight.abs().max()) <= 1 / 8 and float(layer.spline_scaler.abs().max()) <= 1 / 8
    assert float(layer.spline_weight.abs().max()) <= 0.1 / 10
    assert float(layer.base_weight.std()) > 0.05  # uniform on +-1/8, std 0.072


@pytest.mark.parametrize("E, B, IN, OUT", [(4, 64, 256, 1024), (4, 64, 1024, 7), (1, 40, 64, 200), (1, 3, 5, 7),
                                           (2, 33, 20, 70), (1, 65535 * 32, 8, 8), (4, 1, 1, 1), (3, 130, 37, 9),
                                           (2, 129, 33, 16), (4, 65, 257, 17), (1, 1, 100, 1024), (4, 1, 256, 1024)])
def test_kan_split_plan_covers_the_inputs(E, B, IN, OUT):
    """The wrapper's launch plan: whole 32-input stages a split, every input in
    exactly one split, no empty split; narrow tiles (64 batch rows by 8 or 16
    outputs) at OUT <= 16, wide ones (128 weight rows by 64 batch rows) above,
    covering every output; the splits fill about one block an SM."""
    p = tks.plan(E, B, IN, OUT, 132)
    assert p.per % 32 == 0 and (p.splits - 1) * p.per < IN <= p.splits * p.per
    covered = np.zeros(IN, int)
    for s in range(p.splits):
        covered[s * p.per:(s + 1) * p.per] += 1
    assert (covered == 1).all()
    if OUT <= 16:
        assert p.bn == (8 if OUT <= 8 else 16) and p.row_tiles * 64 >= B > (p.row_tiles - 1) * 64
        assert p.col_tiles * p.bn >= OUT > (p.col_tiles - 1) * p.bn
    else:
        assert p.bn == 64 and p.row_tiles * 128 >= OUT > (p.row_tiles - 1) * 128
        assert p.col_tiles * 64 >= B > (p.col_tiles - 1) * 64
    assert p.tiles == E * p.row_tiles * p.col_tiles and p.blocks < min(2 ** 31, 132 + p.tiles)
    if (E, B, IN, OUT) == (4, 64, 1024, 7):  # the classifier layer: one 8-column tile an expert, 32 splits of 32
        assert (p.bn, p.splits, p.per) == (8, 32, 32)
    if (E, B, IN, OUT) == (4, 64, 256, 1024):  # layer 0: 32 wide tiles, 4 splits of 64 inputs, 128 blocks
        assert (p.bn, p.splits, p.per, p.blocks) == (64, 4, 64, 128)


def _round_tf32(v):
    """float32 to TF32 as cvt.rna.tf32.f32 rounds (csrc/kan_spline.cu): to nearest,
    ties away from zero, on the 13 low mantissa bits (finite values)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(v):
    """The kernel's (hi, lo) of a float32 operand: hi = tf32(v), lo = tf32(v - hi)."""
    hi = _round_tf32(v)
    return hi, _round_tf32(v.float() - hi)


def _kan_3xtf32(x, grid, bw, sw):
    """The kernel's arithmetic in plain torch: the bases operand [silu(x) |
    bases(x)] and the weights [Wb | Ws], each split into a TF32 high and low
    part (tf32_split: cvt.rna's rounding), and hi hi + hi lo + lo hi in
    float32 (the dropped lo lo is about 2^-22 of each product)."""
    a = torch.cat([x / (1.0 + torch.exp(-x)), tks.b_splines(x, grid, 3).reshape(x.shape[0], -1)], dim=1)
    w = torch.cat([bw, sw.reshape(sw.shape[0], -1)], dim=1)
    (ahi, alo), (whi, wlo) = tf32_split(a), tf32_split(w)
    return ahi @ whi.T + ahi @ wlo.T + alo @ whi.T


def test_tf32_split_is_round_to_nearest_away():
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12, 3.0e-3, 0.0])
    hi, lo = tf32_split(v)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    # a tie (half a TF32 step) rounds away from zero; below it, down
    torch.testing.assert_close(hi[:4], torch.tensor([1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10]),
                               atol=0, rtol=0)
    assert ((hi + lo - v).abs() <= 2.0 ** -22 * v.abs()).all()


# the MoE bank's two layers at narrower widths: layer 0 (x shared, wide), layer 1 (x per expert, OUT 7)
@pytest.mark.parametrize("E, B, IN, OUT, shared", [(4, 16, 64, 256, True), (4, 16, 256, 7, False)])
def test_3xtf32_products_meet_the_tolerance(E, B, IN, OUT, shared):
    """The tensor-core route's arithmetic against the JAX package's reference,
    within the kernels' float32 tolerance, max |d| <= 1e-4 * max |ref|."""
    x, grid, bw, sw = kan_inputs(B, IN, OUT, seed=IN + OUT, E=E)
    for e in range(E):
        xe = x[0] if shared else x[e]
        ref = np.asarray(jks.kan_forward_ref(*map(jnp.asarray, (xe, grid[e], bw[e], sw[e])), 3))
        out = _kan_3xtf32(*map(T, (np.ascontiguousarray(xe), grid[e], bw[e], sw[e]))).numpy()
        _close(out, ref, frac=1e-4)


def _stacked(mod):
    return [(torch.stack([l.grid for l in bank]), torch.stack([l.base_weight for l in bank]),
             torch.stack([l.scaled_spline_weight() for l in bank])) for bank in zip(*(e.layers for e in mod.experts))]


def _bit_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_moe_bank_cache_is_the_stack_bit_for_bit(moe_pair):
    *_, mod, x = moe_pair
    with torch.no_grad():
        mod(T(x))
        cached = mod.stacked_layers()
        assert mod.stacked_layers() is cached  # kept between forwards
        assert all(_bit_equal(c, w) for got, want in zip(cached, _stacked(mod)) for c, w in zip(got, want))


@pytest.mark.parametrize("name", ["spline_scaler", "spline_weight", "base_weight", "grid"])
def test_moe_bank_cache_is_remade_after_an_in_place_change(name):
    mod = init_parameters(tmoe.MoE(16, 7, 4, 2, expert_layers=(16, 24, 7)), torch.Generator().manual_seed(5))
    x = T((np.random.default_rng(6).standard_normal((6, 16)) * 0.8).astype(np.float32))
    with torch.no_grad():
        before = mod.expert_bank(x)
        cached = mod.stacked_layers()
        getattr(mod.experts[2].layers[1], name).mul_(1.25)
        after = mod.expert_bank(x)
        assert mod.stacked_layers() is not cached
        assert all(_bit_equal(c, w) for got, want in zip(mod.stacked_layers(), _stacked(mod)) for c, w in zip(got, want))
        assert not torch.equal(before[2], after[2]) and torch.equal(before[:2], after[:2])
        torch.testing.assert_close(after[2], mod.experts[2](x), atol=1e-6, rtol=0)


def test_moe_bank_backward_reaches_the_parameters():
    """With gradients on, the bank is stacked in the forward (a kept one is not used,
    even after an inference forward kept one): backward reaches every expert's
    parameters, with the gradients each expert's own KAN gives."""
    mod = init_parameters(tmoe.MoE(16, 7, 4, 2, expert_layers=(16, 24, 7)), torch.Generator().manual_seed(7))
    x = T((np.random.default_rng(8).standard_normal((6, 16)) * 0.8).astype(np.float32))
    with torch.inference_mode():
        mod.expert_bank(x)
    assert mod._bank is not None
    mod.expert_bank(x).square().sum().backward()
    got = {n: p.grad.clone() for n, p in mod.named_parameters() if n.startswith("experts.")}
    mod.zero_grad(set_to_none=True)
    sum(e(x).square().sum() for e in mod.experts).backward()
    for name in ("spline_weight", "spline_scaler", "base_weight"):
        assert any(name in n for n in got)
    for n, p in mod.named_parameters():
        if n.startswith("experts."):
            assert got[n].abs().sum() > 0, n
            torch.testing.assert_close(got[n], p.grad, atol=1e-6, rtol=1e-5)


def test_moe_bank_of_inference_tensors_follows_an_in_place_change():
    """Parameters made in inference mode carry no version counter, so the bank is
    stacked on each call: an in-place change shows in the next forward."""
    with torch.inference_mode():
        mod = init_parameters(tmoe.MoE(16, 7, 4, 2, expert_layers=(16, 24, 7)), torch.Generator().manual_seed(5))
        x = T((np.random.default_rng(6).standard_normal((6, 16)) * 0.8).astype(np.float32))
        before = mod.expert_bank(x)
        mod.experts[1].layers[0].spline_scaler.mul_(1.5)
        after = mod.expert_bank(x)
        assert not torch.equal(before[1], after[1]) and torch.equal(before[0], after[0])
        torch.testing.assert_close(after[1], mod.experts[1](x), atol=1e-6, rtol=0)


def test_moe_head_matches_jax_after_its_bank_is_remade(moe_pair):
    """The MoE head as test_moe_head_matches_jax holds it, on one set of weights
    and then, after load_state_dict, on another: the kept bank follows."""
    _, params, state, _, x = moe_pair
    jhead = jheads.MoEHead(hidden_dim=16, num_classes=7, dropout=0.1, num_experts=4, k=2, dtype=jnp.float32)
    var = jhead.init(jax.random.PRNGKey(2), jnp.asarray(x))
    head = theads.MoEHead(16, 7, dropout=0.1, num_experts=4, k=2).eval()
    for seed in (9, 10):
        hp, hs = _perturb(var["params"], seed), var["kan_state"]
        ref = jhead.apply({"params": hp, "kan_state": hs}, jnp.asarray(x))
        head.load_state_dict(moe_state_dict_from_jax(hp["moe"], hs["moe"], "moe."), strict=True)
        with torch.no_grad():
            out = head(T(x))
            assert head(T(x)).equal(out)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
