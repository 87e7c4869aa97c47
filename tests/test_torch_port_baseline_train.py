"""The baseline family's training against the JAX package, on the CPU in float32.

Modules: ``GroupKANLinear`` and the ``kan``, ``residual`` and
``attention_pooling`` heads; the focal and supervised contrastive losses;
stain normalisation; ``selective_scan``'s associative scan and the op's
gradient; the KAN re-gridding. Then the config-driven ``Trainer`` on the
family: one step against the JAX Trainer's loss function (multiscale + kan,
mamba + mlp, multiscale + moe, focal, SupCon), validation, the re-grid,
the pretrained towers, ``fit``, ``run_train --family baseline`` ->
``run_predict`` -> a resume, a resume under another configuration (the
SupCon recipe's stage 2 from stage 1's ``last.pt``), one epoch of
``run_train`` with each of the other fusions, and the refusals that remain.

Weights come from the JAX ``init`` with biases, affines, ``act_coeff`` /
``act_base``, spline scalers and BatchNorm statistics moved off their init
values, carried across by the port's converters or a JAX msgpack checkpoint.
Sizes: ResNet18 at 56^2, the tiny BERT (2 layers, 64 wide), hidden 32,
batches of 4. The tolerance of each test is in its docstring.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.modules import heads as jheads
from mdhs_tpu.modules import kan as jkan
from mdhs_tpu.ops import selective_scan as jss
from mdhs_tpu.ops import stain_norm as jstain
from mdhs_tpu.train import losses as jlosses
from mdhs_tpu_torch.core.convert import head_state_dict_from_jax
from mdhs_tpu_torch.modules import heads as theads
from mdhs_tpu_torch.modules import kan as tkan
from mdhs_tpu_torch.ops import kan_spline as tks
from mdhs_tpu_torch.ops import selective_scan as tss
from mdhs_tpu_torch.ops import stain_norm as tstain
from mdhs_tpu_torch.train import losses as tlosses

torch.set_num_threads(2)
T = torch.from_numpy
ACTS = ("gelu", "silu", "relu", "identity")


def _close(out, ref, frac, floor=0.0):
    """max |out - ref| <= frac * max(floor, max |ref|)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and np.isfinite(out).all()
    d, scale = np.abs(out - ref).max(), max(floor, np.abs(ref).max())
    assert d <= frac * scale, (d, scale)


def _perturb(tree, seed):
    """Biases, LayerNorm / BatchNorm affines and statistics, act_base and act_coeff,
    spline scalers, Mamba's dt_bias, A_log and D off their init values; the MoE
    gate drawn (a zero gate ties every expert)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("bias", "conv1d_bias", "dt_bias"):
            return (a + rng.uniform(-0.2, 0.2, a.shape)).astype(np.float32)
        if name in ("scale", "act_base", "D", "var"):
            return (a * rng.uniform(0.6, 1.4, a.shape)).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        if name == "act_coeff":
            return (a + rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if name == "spline_scaler":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if name == "A_log":
            return (a + rng.uniform(-0.3, 0.3, a.shape)).astype(np.float32)
        if name in ("w_gate", "w_noise"):
            return (rng.standard_normal(a.shape) * 0.5).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _x(seed, shape=(9, 16), scale=2.5):
    """Inputs across the GroupKAN grid (-4, 4) and beyond it."""
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    x.flat[:8] = [-5.0, -4.0, -3.999, 0.0, 1.0, 3.999, 4.0, 6.0]
    return x


# --------------------------------------------------------------------------- GroupKAN and the heads
@pytest.mark.parametrize("act", ACTS)
def test_group_kan_linear_matches_jax(act):
    """max |d| <= 1e-5 * max(1, max |ref|), float32."""
    x = _x(1)
    jmod = jkan.GroupKANLinear(16, 12, num_groups=4, act_mode=act, dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    mod = tkan.GroupKANLinear(16, 12, num_groups=4, act_mode=act)
    mod.load_state_dict({"act_coeff": T(params["act_coeff"]), "act_base": T(params["act_base"]),
                         "linear.weight": T(np.ascontiguousarray(params["linear"]["kernel"].T)),
                         "linear.bias": T(params["linear"]["bias"])}, strict=True)
    assert set(mod.state_dict()) == {"act_coeff", "act_base", "linear.weight", "linear.bias"}  # the grid is constant
    with torch.no_grad():
        _close(mod(T(x)).numpy(), ref, 1e-5, 1.0)


def _jax_head(kind, act="gelu"):
    kw = dict(hidden_dim=16, num_classes=7, dropout=0.1, dtype=jnp.float32)
    if kind == "kan":
        return jheads.KANHead(num_groups=4, act_mode=act, **kw)
    if kind == "attention_pooling":
        return jheads.AttentionPoolingHead(num_heads=4, **kw)
    return jheads.ResidualHead(**kw)


def _port_head(kind, act="gelu"):
    return theads.build_head(kind, hidden_dim=16, num_classes=7, dropout=0.1, num_heads=4, kan_num_groups=4,
                             kan_act_mode=act)


@pytest.mark.parametrize("kind, act", [("kan", a) for a in ACTS] + [("residual", None), ("attention_pooling", None)])
def test_heads_match_jax(kind, act):
    """The eval forward: max |d| <= 1e-5 * max(1, max |ref|), float32 logits."""
    x = _x(3, scale=1.5)
    jhead = _jax_head(kind, act or "gelu")
    params = _perturb(jhead.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 5)
    ref = jhead.apply({"params": params}, jnp.asarray(x))
    head = _port_head(kind, act or "gelu").eval()
    head.load_state_dict(head_state_dict_from_jax(params, None, kind), strict=True)
    with torch.no_grad():
        out = head(T(x))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref, 1e-5, 1.0)


@pytest.mark.parametrize("kind", ["kan", "residual", "attention_pooling"])
def test_head_gradients_match_jax(kind):
    """Gradients of <logits, cot> with dropout off: each parameter's within 1e-5 of
    the largest |ref| among the head's gradients."""
    x = _x(6, scale=1.5)
    cot = np.random.default_rng(7).standard_normal((9, 7)).astype(np.float32)
    jhead = _jax_head(kind)
    params = _perturb(jhead.init(jax.random.PRNGKey(8), jnp.asarray(x))["params"], 9)
    jg = jax.grad(lambda p: (jhead.apply({"params": p}, jnp.asarray(x)) * cot).sum())(params)
    head = _port_head(kind).eval()
    head.load_state_dict(head_state_dict_from_jax(params, None, kind), strict=True)
    (head(T(x)) * T(cot)).sum().backward()
    want = head_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg), None, kind)
    scale = max(float(v.abs().max()) for v in want.values())
    for name, p in head.named_parameters():
        assert float((p.grad - want[name]).abs().max()) <= 1e-5 * scale, name


# --------------------------------------------------------------------------- the losses
def _loss_inputs(seed, n=8):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, 7)) * 2.0).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int64)
    return (logits, labels, rng.uniform(0.5, 2.0, 7).astype(np.float32),
            np.array([1.0] * (n - 3) + [0.0] * 3, np.float32), rng.standard_normal((n, 16)).astype(np.float32))


@pytest.mark.parametrize("weights, mask", [(False, False), (True, False), (False, True), (True, True)])
def test_focal_loss_and_its_gradient_match_jax(weights, mask):
    """The value within 1e-6 relative, the gradient within 1e-5 of max |ref|."""
    logits, labels, cw, m, _ = _loss_inputs(1)
    jkw = {"gamma": 2.0, "class_weights": jnp.asarray(cw) if weights else None,
           "sample_mask": jnp.asarray(m) if mask else None}
    jval, jgrad = jax.value_and_grad(lambda z: jlosses.focal_loss(z, jnp.asarray(labels), **jkw))(jnp.asarray(logits))
    z = T(logits).requires_grad_()
    val = tlosses.LOSSES["focal"](z, T(labels), gamma=2.0, class_weights=T(cw) if weights else None,
                                  sample_mask=T(m) if mask else None)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-6)
    _close(z.grad.numpy(), jgrad, 1e-5)


@pytest.mark.parametrize("mask", [False, True])
def test_supcon_loss_and_its_gradient_match_jax(mask):
    """Pad rows out of the positives and the denominator; the row max without a
    gradient. The value within 1e-6 relative, the gradient within 1e-5 of max |ref|."""
    _, labels, _, m, feats = _loss_inputs(2)
    sm = jnp.asarray(m) if mask else None
    jval, jgrad = jax.value_and_grad(lambda f: jlosses.supcon_loss(f, jnp.asarray(labels), 0.07, sm))(jnp.asarray(feats))
    f = T(feats).requires_grad_()
    val = tlosses.supcon_loss(f, T(labels), 0.07, T(m) if mask else None)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-6)
    _close(f.grad.numpy(), jgrad, 1e-5)
    if mask:
        assert float(f.grad[-3:].abs().max()) == 0.0  # pad rows take no gradient


def test_ce_loss_smooths_by_default_as_jax():
    logits, labels, cw, m, _ = _loss_inputs(3)
    ref = jlosses.LOSSES.get("ce")(jnp.asarray(logits), jnp.asarray(labels), class_weights=jnp.asarray(cw),
                                   sample_mask=jnp.asarray(m))
    out = tlosses.LOSSES["ce"](T(logits), T(labels), class_weights=T(cw), sample_mask=T(m))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


# --------------------------------------------------------------------------- stain normalisation
def _stain_f64(x, tm=(150.0, 140.0, 140.0), ts=(20.0, 20.0, 20.0)):
    """The reference's math in float64 numpy (exact moments of a flat image)."""
    x = x.astype(np.float64)
    m = np.array(jstain._RGB2XYZ, np.float64)
    white = np.array(jstain._XYZ_REF, np.float64)
    lin = np.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)
    xyz = lin @ m.T / white
    d = 6 / 29
    f = np.where(xyz > d ** 3, np.cbrt(xyz), xyz / (3 * d * d) + 4 / 29)
    lab = np.stack([(116 * f[..., 1] - 16) * 255 / 100, 500 * (f[..., 0] - f[..., 1]) + 128,
                    200 * (f[..., 1] - f[..., 2]) + 128], -1)
    mean, std = lab.mean(axis=(1, 2), keepdims=True), lab.std(axis=(1, 2), keepdims=True)
    lab = np.clip((lab - mean) / np.where(std < 1e-6, 1.0, std) * ts + np.asarray(tm), 0, 255)
    fy = (lab[..., 0] * 100 / 255 + 16) / 116
    fxyz = np.stack([fy + (lab[..., 1] - 128) / 500, fy, fy - (lab[..., 2] - 128) / 200], -1)
    xyz = np.where(fxyz > d, fxyz ** 3, 3 * d * d * (fxyz - 4 / 29)) * white
    lin = np.clip(xyz @ np.linalg.inv(m).T, 0, 1)
    return np.clip(np.where(lin > 0.0031308, 1.055 * lin ** (1 / 2.4) - 0.055, 12.92 * lin), 0, 1)


def test_stain_normalize_matches_jax():
    """Seeded images in [0, 1], saturated ones (every pixel 0 or 1, a pure red
    patch), a colour ramp and a near-black image, under two targets: max |d| <=
    1e-4 against JAX and against the float64 math. (A gray image is left out:
    its a and b channels are flat but for rounding, whose std passes the 1e-6
    floor in every precision, so any two implementations differ there.)"""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (6, 20, 14, 3)).astype(np.float32)
    x[1] = rng.uniform(0, 1, (20, 14, 3)) > 0.5
    x[2, :10] = [1.0, 0.0, 0.0]
    x[3] = np.stack([np.linspace(0, 1, 14), np.full(14, 0.3), np.linspace(0.9, 0.1, 14)], -1)[None]
    x[4] = rng.uniform(0.0, 0.02, (20, 14, 3))  # near black: the linear branches of both transfer curves
    for tm, ts in (((150.0, 140.0, 140.0), (20.0, 20.0, 20.0)), ((120.0, 135.0, 125.0), (35.0, 8.0, 12.0))):
        ref = jstain.stain_normalize(jnp.asarray(x), tm, ts)
        out = tstain.stain_normalize(T(x), tm, ts)
        assert out.dtype == torch.float32
        _close(out.numpy(), ref, 1e-4, 1.0)
        _close(out.numpy(), _stain_f64(x, tm, ts), 1e-4, 1.0)


def test_stain_normalize_of_a_flat_image_is_the_target():
    """A flat image (its std below the 1e-6 floor) comes out at the target moments,
    as the float64 reference math gives it, within 1e-4; JAX's float32 mean leaves
    a residue of one ulp of L there, which its division blows up (ROADMAP Queue 3)."""
    x = np.zeros((4, 16, 12, 3), np.float32)
    x[0], x[1], x[2], x[3] = 0.5, 0.3, 1.0, 0.0
    _close(tstain.stain_normalize(T(x)).numpy(), _stain_f64(x), 1e-4, 1.0)


def test_stain_constants_are_made_once_per_device():
    a = tstain._constants(torch.device("cpu"), (150, 140, 140), (20, 20, 20))
    b = tstain._constants(torch.device("cpu"), (150.0, 140.0, 140.0), (20.0, 20.0, 20.0))
    assert all(u is v for u, v in zip(a, b))
    np.testing.assert_allclose(a[1].numpy().T, np.linalg.inv(np.asarray(jstain._RGB2XYZ, np.float32)), rtol=1e-6)


# --------------------------------------------------------------------------- selective_scan's gradient
def _scan_inputs(seed, B, L, D, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, D)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((B, L, D)))).astype(np.float32),
            -np.exp(rng.standard_normal((D, N)) * 0.5).astype(np.float32),
            rng.standard_normal((B, L, N)).astype(np.float32), rng.standard_normal((B, L, N)).astype(np.float32),
            rng.standard_normal(D).astype(np.float32))


@pytest.mark.parametrize("B, L, D, N", [(2, 49, 16, 16), (3, 7, 5, 4), (1, 1, 3, 2), (2, 64, 8, 8)])
def test_associative_scan_matches_jax(B, L, D, N):
    """selective_scan_associative against selective_scan_ref (jax.lax.associative_scan):
    max |d| <= 1e-5 * max |ref|; and the op's six gradients against jax.vjp of the JAX
    custom-VJP op: each within 1e-5 of its max |ref|."""
    args = _scan_inputs(B + L, B, L, D, N)
    ref = jss.selective_scan_ref(*map(jnp.asarray, args))
    _close(tss.selective_scan_associative(*map(T, args)).numpy(), ref, 1e-5)
    g = np.random.default_rng(L).standard_normal((B, L, D)).astype(np.float32)
    _, vjp = jax.vjp(jss.selective_scan, *map(jnp.asarray, args))
    leaves = [T(a).clone().requires_grad_() for a in args]
    n = tss.selective_scan.launches
    tss.selective_scan(*leaves).backward(T(g))
    assert tss.selective_scan.launches == n  # a CPU tensor takes the plain versions, both ways
    for name, leaf, r in zip(("x", "dt", "A", "B", "C", "D"), leaves, vjp(jnp.asarray(g))):
        if np.abs(np.asarray(r)).max() == 0.0:  # A at L = 1: h_0 = 0 takes no decay
            assert float(leaf.grad.abs().max()) == 0.0, name
        else:
            _close(leaf.grad.numpy(), r, 1e-5)


def test_scan_gradient_passes_gradcheck_in_float64():
    args = [T(a).double().requires_grad_() for a in _scan_inputs(3, 2, 5, 3, 2)]
    assert torch.autograd.gradcheck(lambda *a: tss.selective_scan(*a), args, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_scan_backward_recomputes_and_keeps_only_the_inputs():
    """The op saves its six inputs for the backward and nothing of the scan."""
    leaves = [T(a).requires_grad_() for a in _scan_inputs(5, 2, 9, 4, 3)]
    y = tss.selective_scan(*leaves)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 6 and all(s.shape == a.shape for s, a in zip(saved, leaves))


# --------------------------------------------------------------------------- KAN re-gridding
def _kan_fn(x, grid, bw, sw, scaler):
    return tks.kan_forward_reference(T(x), T(np.asarray(grid)), T(bw), T(np.asarray(sw) * scaler[..., None]),
                                     3).numpy()


def _layer(seed, IN=12, OUT=9, init_scale=False):
    """Inputs off the grid's centre and past its edges; spline weights at the
    KANLinear init's scale (uniform +-0.01, the scaler +-1/sqrt(IN)) or 0.1 normal."""
    rng = np.random.default_rng(seed)
    spread = 0.5 if init_scale else 0.6
    x = (rng.standard_normal((40, IN)) * spread + rng.uniform(-0.3, 0.3, IN)).astype(np.float32)
    bound = 1 / np.sqrt(IN)
    bw = rng.uniform(-bound, bound, (OUT, IN)).astype(np.float32)
    if init_scale:
        sw = rng.uniform(-0.01, 0.01, (OUT, IN, 8)).astype(np.float32)
        scaler = rng.uniform(-bound, bound, (OUT, IN)).astype(np.float32)
    else:
        sw = (rng.standard_normal((OUT, IN, 8)) * 0.1).astype(np.float32)
        scaler = rng.uniform(0.5, 1.5, (OUT, IN)).astype(np.float32)
    return x, np.asarray(jkan.make_grid(IN, 5, 3)), bw, sw, scaler


def _check_regrid(x, grid, bw, sw, scaler):
    """Grid and spline weight within 1e-4 of max |ref| of JAX's kan_update_grid, the
    refit layer's function on x within 1e-5 of JAX's refit's; returns the port's
    largest change of the function on x."""
    jp, js = jkan.kan_update_grid({"spline_weight": sw, "spline_scaler": scaler}, {"grid": grid}, x, "",
                                  grid_size=5, spline_order=3)
    new_sw, new_grid = tkan.kan_update_grid(x, grid, sw, scaler, grid_size=5, spline_order=3)
    _close(new_grid, js["grid"], 1e-4)
    _close(new_sw, jp["spline_weight"], 1e-4)
    after = _kan_fn(x, new_grid, bw, new_sw, scaler)
    _close(after, _kan_fn(x, js["grid"], bw, jp["spline_weight"], scaler), 1e-5)
    assert not np.allclose(new_grid, grid)
    return float(np.abs(after - _kan_fn(x, grid, bw, sw, scaler)).max())


@pytest.mark.parametrize("init_scale", [True, False])
def test_kan_update_grid_matches_jax_for_one_layer(init_scale):
    """``_check_regrid``'s bounds; at the init's scale, with inputs of std 0.5 (the
    JAX package's own preservation test), the function on the captured inputs is
    kept within 1e-3. With spline weights ten times the init's the least-squares
    refit moves it by about 1.5 % of max |f|, in JAX as in the port (held equal)."""
    change = _check_regrid(*_layer(0, init_scale=init_scale))
    if init_scale:
        assert change <= 1e-3, change


def test_kan_update_grid_matches_jax_for_a_bank():
    """A 4-expert bank, each expert on its own inputs as the JAX Trainer's loop
    re-grids a vmapped bank: ``_check_regrid``'s bounds expert by expert, and the
    function kept within 1e-3 at the init's scale."""
    for e in range(4):
        assert _check_regrid(*_layer(10 + e, IN=16, OUT=7, init_scale=True)) <= 1e-3


# --------------------------------------------------------------------------- the Trainer against the JAX Trainer
from mdhs_tpu.core import checkpoint as jckpt  # noqa: E402
from mdhs_tpu.core.config import Config as JConfig  # noqa: E402
from mdhs_tpu.modules import moe as jmoe  # noqa: E402
from mdhs_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from mdhs_tpu_torch.cli import run_predict as tpredict  # noqa: E402
from mdhs_tpu_torch.cli import run_train as trun_train  # noqa: E402
from mdhs_tpu_torch.core import checkpoint as tckpt  # noqa: E402
from mdhs_tpu_torch.core.config import Config  # noqa: E402
from mdhs_tpu_torch.core.convert import baseline_state_dict_from_jax  # noqa: E402
from mdhs_tpu_torch.models.baseline import MultimodalBaselineModel  # noqa: E402
from mdhs_tpu_torch.models.init import init_parameters  # noqa: E402
from mdhs_tpu_torch.models.resnet import ResNetClassifier  # noqa: E402
from mdhs_tpu_torch.ops import augment as taug  # noqa: E402
from mdhs_tpu_torch.ops.preprocess import eval_pipeline  # noqa: E402
from mdhs_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_port_augment import _jax_sampled_values  # noqa: E402
from test_torch_port_train_cli import (B, CANVAS, CROP, _hf_bert_file, flat_cos, jax_batch,  # noqa: E402
                                       train_config, write_dataset)

ARCHS = {"kan": ("multiscale", "kan"), "mamba": ("mamba", "mlp"), "moe": ("multiscale", "moe")}
TOWERS = ("image_encoder", "text_encoder", "fusion", "classifier")


def baseline_config(paths, root, fusion, head, **training) -> dict:
    """``train_config`` for the baseline family: ``fusion`` + ``head`` at hidden 32,
    dropout 0 in the fusion and the head, the MoE's balance weight 0.05."""
    cfg = train_config(paths, root, "baseline", **training)
    cfg["model"].update(fusion_type=fusion, classifier_type=head)
    cfg["model"]["mlp_head"]["dropout"] = 0.0
    cfg["model"]["moe"] = {"num_experts": 4, "k": 2, "balance_weight": 0.05}
    return cfg


def _torchvision_resnet18_file(path, seed):
    """A torchvision resnet18 state dict, its 1000-class fc included, from a seeded port tower."""
    tower = init_parameters(ResNetClassifier("resnet18", num_outputs=1000), torch.Generator().manual_seed(seed))
    sd = dict(tower.state_dict())
    for k, v in sd.items():
        if k.endswith("running_mean") or k.endswith(".bias"):
            v += 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(len(k)))
    torch.save(sd, path)
    return sd


def _no_dropout(jt, pt):
    jt.model = jt.model.clone(cfg=dataclasses.replace(
        jt.model.cfg, bert=dataclasses.replace(jt.model.cfg.bert, hidden_dropout=0.0, attention_dropout=0.0)))
    for m in pt.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def _jax_sd(jt, grads=None):
    """The JAX trainer's params (or ``grads``) under the port's names."""
    c = jt.model.cfg
    params = jax.tree_util.tree_map(np.asarray, jt.state.params if grads is None else grads)
    stats = jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)
    kan = jax.tree_util.tree_map(np.asarray, jt.state.kan_state) if jt.state.kan_state else None
    return baseline_state_dict_from_jax(params, stats, kan, c.fusion_type, c.classifier_type)


def _carry(jt, pt, root, seed):
    """The JAX init's weights and BatchNorm statistics, perturbed from ``seed``, into
    both trainers (a msgpack the port reads)."""
    params, stats = jt.init_state
    jt.state = jt.state.replace(params=_perturb(params, seed), batch_stats=_perturb(stats, seed + 1))
    path = str(root / "carried.msgpack")
    jckpt.save_checkpoint(path, jt.checkpoint_state())
    pt.load_weights(path)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """A JAX and a port Trainer on one config for each architecture, built once;
    the ``kan`` pair's config names torchvision ResNet18 and HF BERT towers."""
    root = tmp_path_factory.mktemp("train_baseline")
    paths = write_dataset(root / "data")
    made = {}
    for name, (fusion, head) in ARCHS.items():
        cfg = baseline_config(paths, root / name, fusion, head)
        files = None
        if name == "kan":
            (root / name).mkdir()
            cfg["model"]["image_encoder"]["pretrained_path"] = str(root / name / "resnet18.pth")
            cfg["model"]["text_encoder"]["pretrained_path"] = str(root / name / "bert.bin")
            files = {"image": _torchvision_resnet18_file(cfg["model"]["image_encoder"]["pretrained_path"], 5),
                     "text": _hf_bert_file(cfg["model"]["text_encoder"]["pretrained_path"], cfg, 6, rooted=True)}
        jt = JTrainer(JConfig(cfg), family="baseline", output_dir=str(root / name / "jax_run"))
        jt.init_state = (jt.state.params, jt.state.batch_stats)
        pt = Trainer(Config(cfg), "baseline", output_dir=str(root / name / "port_run"), device="cpu")
        made[name] = {"root": root / name, "cfg": cfg, "jax": jt, "port": pt, "files": files}
    return made


@pytest.mark.parametrize("tower", ["image", "text"])
def test_baseline_pretrained_towers_load_as_the_jax_trainer_loads_them(pairs, tower):
    """A torchvision resnet18 (its fc dropped) and an HF BertModel (``bert.`` rooted,
    its pooler dropped): the same values through the port's loader as through JAX's
    convert_resnet / convert_bert, and the file's, bit for bit."""
    pair = pairs["kan"]
    jsd, tsd = _jax_sd(pair["jax"]), pair["port"].state_dict()
    prefix, key = (("image_encoder.model.", lambda k: k) if tower == "image" else ("text_encoder.model.",
                                                                                    lambda k: "bert." + k))
    names = [k for k in tsd if k.startswith(prefix) and not k.endswith("num_batches_tracked")]
    assert names
    sd = pair["files"][tower]
    for k in names:
        assert torch.equal(tsd[k].float(), jsd[k].float()), k
        assert torch.equal(tsd[k].float(), sd[key(k[len(prefix):])].float()), k


STEP_CASES = {  # (architecture, loss settings of both trainers, stain normalisation)
    "base_kan": ("kan", {}, False),
    "mamba_mlp": ("mamba", {}, True),
    "moe": ("moe", {}, False),
    "focal": ("kan", {"loss_type": "focal"}, False),
    "supcon_pretrain": ("kan", {"supcon_stage": "pretrain"}, False),
    "supcon_finetune": ("mamba", {"supcon_stage": "finetune"}, False),
}


def _set_losses(jt, pt, loss_type="ce", supcon_stage=None, stain=False):
    jt.loss_type = loss_type
    jt.supcon_enabled, jt.supcon_stage = supcon_stage is not None, supcon_stage or "finetune"
    jt.stain_cfg = {"enabled": True} if stain else {}
    pt.preset = dataclasses.replace(pt.preset, loss_type=loss_type, supcon_stage=supcon_stage,
                                    stain=((150.0, 140.0, 140.0), (20.0, 20.0, 20.0)) if stain else None)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_baseline_train_step_matches_the_jax_trainer(pairs, case, monkeypatch):
    """One step of the config-driven Trainer against the JAX Trainer's ``_loss_fn`` on
    the same weights, batch (three rows kept, labels with a SupCon positive pair
    and a negative, the padded tail masked), augmented images (the JAX
    sampler's crop, flips, 45-degree rotation and jitter factors; stain
    normalisation in the mamba case) and gating noise, dropout off: the images atol
    1e-5 (1e-4 with the stain pass), the loss rtol 1e-5, the logits atol 2e-4 / rtol
    1e-3, each tower's gradient cosine >= 0.9999, the ResNet's updated running
    statistics atol 1e-5."""
    arch, losses, stain = STEP_CASES[case]
    pair = pairs[arch]
    jt, pt = pair["jax"], pair["port"]
    _no_dropout(jt, pt)
    _carry(jt, pt, pair["root"], seed=31)
    _set_losses(jt, pt, stain=stain, **losses)
    batch = dict(list(pt.val_loader)[-1])
    assert int(batch["n_valid"]) == 2
    # three kept rows, one padded: a SupCon positive pair and a negative
    batch["n_valid"], batch["label"] = np.int32(3), np.array([3, 3, 5, 3], batch["label"].dtype)
    key = jax.random.PRNGKey(4)
    k_aff, k_col = jax.random.split(key)
    jimages = np.asarray(jt._preprocess_train(key, jnp.asarray(batch["image"])), np.float32)
    kb, kc, ks, kh = jax.random.split(k_col, 4)
    f = [jax.random.uniform(k_, (B, 1, 1, 1), minval=0.8, maxval=1.2) for k_ in (kb, kc, ks)]
    f.append(jax.random.uniform(kh, (B, 1, 1), minval=-0.1, maxval=0.1))
    jitter = taug.ColorJitter(*(T(np.asarray(a).reshape(B).copy()) for a in f))
    dev = pt.to_device(batch)
    timages = pt.augment(dev["image"], params=_jax_sampled_values(k_aff, B, CANVAS, vflip=True, degrees=45.0),
                         jitter=jitter)
    np.testing.assert_allclose(timages.permute(0, 2, 3, 1).numpy(), jimages, atol=1e-4 if stain else 1e-5, rtol=0)

    noise = np.random.default_rng(33).standard_normal((B, 4)).astype(np.float32)
    real = jmoe.noisy_top_k_gating
    monkeypatch.setattr(jmoe, "noisy_top_k_gating", lambda *a, **kw: real(*a, **{**kw, "noise": jnp.asarray(noise)}))
    (jloss, (jvars, jlogits)), jgrads = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        jt.state.params, jt.state.batch_stats, jt.state.kan_state, jax_batch(batch), jnp.asarray(jimages), key)
    images = T(jimages.copy()).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    loss, out = pt.forward_backward(images, dev, pt.valid_mask(batch, B), noise=T(noise))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jlogits), atol=2e-4, rtol=1e-3)
    assert ("balance" in out) == (arch == "moe")
    jg = _jax_sd(jt, jgrads)
    tg = {n: p.grad for n, p in pt.model.named_parameters()}
    for tower in TOWERS:
        names = [n for n in tg if n.split(".")[0] == tower and (tg[n] is not None or float(jg[n].abs().max()) > 0)]
        if losses.get("supcon_stage") == "pretrain" and tower == "classifier":
            assert all(tg[n] is None for n in names)  # the pretrain stage leaves the head out of the loss
            continue
        c = flat_cos([tg[n].numpy() for n in names], [jg[n].numpy() for n in names])
        assert c >= 0.9999, (tower, c)
    want_stats = baseline_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state.params), jax.tree_util.tree_map(np.asarray, jvars["batch_stats"]),
        jax.tree_util.tree_map(np.asarray, jt.state.kan_state) if jt.state.kan_state else None,
        jt.model.cfg.fusion_type, jt.model.cfg.classifier_type)
    for k, v in pt.model.state_dict().items():
        if k.endswith("running_mean") or k.endswith("running_var"):
            np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    _set_losses(jt, pt)


def test_baseline_validate_matches_the_jax_trainer(pairs):
    """validate(): the eval forward and the training criterion (label-smoothed CE
    with the class weights), no balance loss: mean loss rtol 1e-4, accuracy equal."""
    for name in ("kan", "moe"):
        jt, pt = pairs[name]["jax"], pairs[name]["port"]
        _carry(jt, pt, pairs[name]["root"], seed=41)
        jloss, jacc = jt.validate()
        tloss, tacc = pt.validate()
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
        assert tacc == jacc


def test_kan_regrid_in_the_trainer_matches_the_jax_trainer(pairs):
    """Trainer._kan_regrid on one batch against the JAX Trainer's on the same
    weights: each expert's grid and spline weight of both bank layers within 1e-3
    of max |ref| (the captured inputs come through the whole eval forward, about
    1e-6 from JAX's, and the refit's pseudo-inverse amplifies that; on equal
    inputs the refit is held to 1e-4 above); the float32 masters hold the new weights, the stacked bank is
    made anew, and the eval logits move by less than 0.05 (the JAX package's own
    bound for the re-grid)."""
    pair = pairs["moe"]
    jt, pt = pair["jax"], pair["port"]
    _carry(jt, pt, pair["root"], seed=51)
    batch = next(iter(pt.train_loader))
    moe = pt.model.classifier.moe
    pt.model.eval()
    with torch.no_grad():
        kept = moe.stacked_layers()
        before = pt._val_pass([batch], True)[2][0][0]
    pt.model.train()
    jt._kan_regrid(jax_batch(batch))
    assert pt._kan_regrid(batch) == 2
    want = _jax_sd(jt)
    for k, v in pt.state_dict().items():
        if k.startswith("classifier.moe.experts.") and k.rsplit(".", 1)[1] in ("grid", "spline_weight"):
            _close(v.detach().numpy(), want[k].numpy(), 1e-3)
    masters = dict(zip((n for n, _ in pt.model.named_parameters()), pt.master_parameters()))
    sw = "classifier.moe.experts.1.layers.0.spline_weight"
    assert torch.equal(masters[sw], pt.model.state_dict()[sw])
    pt.model.eval()
    with torch.no_grad():
        assert moe.stacked_layers() is not kept
        assert torch.equal(moe.stacked_layers()[0][0][1], moe.experts[1].layers[0].grid)
        after = pt._val_pass([batch], True)[2][0][0]
    pt.model.train()
    assert float((after - before).abs().max()) < 0.05


# --------------------------------------------------------------------------- fit, the command line, resume
def _cli_config(tmp_path, **training):
    paths = write_dataset(tmp_path / "data")
    cfg = baseline_config(paths, tmp_path, "multiscale", "kan", log_every=2, **training)
    cfg["data"]["stain_normalization"] = {"enabled": True}
    path = str(tmp_path / "cfg.json")
    Config(cfg).save_json(path)
    return cfg, path


def test_run_train_baseline_then_predict_and_resume(tmp_path, monkeypatch):
    """run_train --device cpu (the family defaulting to baseline) on base.yml's
    multiscale + kan with stain normalisation over PNGs on disk: the run directory;
    the best checkpoint bit for bit the trainer's state at its epoch; run_predict over
    it against the trainer's eval forward atol 2e-4 / rtol 1e-3; a resume from
    last.pt going on at the saved step for one more epoch."""
    cfg, cfg_path = _cli_config(tmp_path)
    snapshots = {}
    real = tckpt.TopKCheckpointManager.maybe_save

    def spy(self, epoch, metric, state):
        snapshots[epoch] = {k: v.clone() for k, v in state["state_dict"].items()}
        return real(self, epoch, metric, state)

    monkeypatch.setattr(tckpt.TopKCheckpointManager, "maybe_save", spy)
    before = Trainer(Config(cfg), "baseline", output_dir=str(tmp_path / "init"), device="cpu").state_dict()
    trainer = trun_train.main(["--config", cfg_path, "--device", "cpu"])
    assert trainer.family == "baseline" and trainer.step == 6 and trainer.epoch == 2
    out = trainer.output_dir
    assert {"training.log", "metrics.jsonl", "checkpoints.json", "last.pt", "config.json"} <= set(os.listdir(out))
    tags = [json.loads(line)["tag"] for line in open(os.path.join(out, "metrics.jsonl"))]
    assert tags.count("Loss/Train_Batch") == 3 and tags.count("LearningRate") == 2
    moved = [k for k, v in trainer.state_dict().items() if v.is_floating_point() and not torch.equal(v, before[k])]
    assert any(k.startswith("classifier.kan1.act_coeff") for k in moved) and any(k.startswith("fusion.") for k in moved)
    index = json.load(open(os.path.join(out, "checkpoints.json")))
    best = os.path.join(out, index[0]["path"])
    epoch = int(re.match(r"epoch_(\d+)_", index[0]["path"]).group(1))
    saved = tckpt.load_torch_file(best)
    assert all(torch.equal(saved[k], snapshots[epoch][k]) for k in saved)
    fresh = MultimodalBaselineModel(trainer.model.cfg)
    tckpt.load_weights(fresh, best, "baseline")
    assert all(torch.equal(v, saved[k]) for k, v in fresh.state_dict().items())

    pred = tpredict.main(["--config", cfg_path, "--model_path", best, "--device", "cpu",
                          "--output_path", str(tmp_path / "sub.csv")])
    trainer.load_weights(best)
    trainer.model.eval()
    logits = []
    with torch.inference_mode():
        for b in trainer.val_loader:
            dev = trainer.to_device(b)
            img = eval_pipeline(dev["image"], CROP, normalize=True, dtype=torch.float32)
            logits.append(trainer.model(img, dev["input_ids"], dev["attention_mask"])[: int(b["n_valid"])])
    np.testing.assert_allclose(pred["logits"], torch.cat(logits).numpy(), atol=2e-4, rtol=1e-3)

    last = os.path.join(out, "last.pt")
    resumed = trun_train.main(["--config", cfg_path, "--device", "cpu", "--set", f"training.resume_from={last}",
                               "--set", "training.num_epochs=3"])
    assert resumed.step == 9 and resumed.epoch == 3
    recs = [json.loads(line) for line in open(os.path.join(resumed.output_dir, "metrics.jsonl"))]
    assert [r["step"] for r in recs if r["tag"] == "Loss/Train_Epoch"] == [3]


def test_a_last_pt_of_another_configuration_gives_its_weights_only(tmp_path):
    """The SupCon recipe: stage 2 (finetune) resumes from stage 1's (pretrain)
    last.pt with stage 1's weights, at step 0, epoch 0, with an empty optimizer
    state, so it trains its own schedule; the same run resumed goes on at its step."""
    cfg, _ = _cli_config(tmp_path, num_epochs=1, supcon={"enabled": True, "stage": "pretrain", "temperature": 0.07})
    stage1 = Trainer(Config(cfg), "baseline", output_dir=str(tmp_path / "stage1"), device="cpu")
    stage1.fit()
    last = str(tmp_path / "stage1" / "last.pt")
    assert stage1.step == 3
    cfg2 = json.loads(json.dumps(cfg))
    cfg2["training"]["supcon"] = {"enabled": True, "stage": "finetune", "temperature": 0.07, "weight": 0.1}
    cfg2["training"]["resume_from"] = last
    stage2 = Trainer(Config(cfg2), "baseline", output_dir=str(tmp_path / "stage2"), device="cpu")
    assert stage2.step == 0 and stage2.epoch == 0 and not stage2.optimizer.state_dict()["state"]
    want = tckpt.load_torch_file(last)
    assert all(torch.equal(v, want[k]) for k, v in stage2.checkpoint_state()["state_dict"].items())
    history = stage2.fit()
    assert [h["epoch"] for h in history] == [1] and stage2.step == 3
    same = json.loads(json.dumps(cfg))
    same["training"].update(resume_from=last, num_epochs=2)
    again = Trainer(Config(same), "baseline", output_dir=str(tmp_path / "again"), device="cpu")
    assert again.step == 3 and again.epoch == 1 and again.optimizer.state_dict()["state"]


@pytest.mark.parametrize("fusion", ["concat", "vmamba", "basic", "weighted_concat", "hadamard", "hierarchical"])
def test_run_train_trains_every_fusion(tmp_path, fusion):
    """run_train's check lets each fusion through, and one epoch of 3 steps trains it:
    finite losses, every fusion parameter moved, a checkpoint written."""
    cfg, _ = _cli_config(tmp_path, num_epochs=1)
    cfg["model"]["fusion_type"] = fusion
    path = str(tmp_path / "fusion.json")
    Config(cfg).save_json(path)
    init = Trainer(Config(cfg), "baseline", output_dir=str(tmp_path / "init"), device="cpu").model
    before = {n: p.detach().clone() for n, p in init.named_parameters() if n.startswith("fusion.")}
    trainer = trun_train.main(["--config", path, "--device", "cpu"])
    assert trainer.step == 3 and before
    losses = [json.loads(line) for line in open(os.path.join(trainer.output_dir, "metrics.jsonl"))]
    assert all(np.isfinite(r["value"]) for r in losses if r["tag"] == "Loss/Train_Batch")
    after = dict(trainer.model.named_parameters())
    assert all(not torch.equal(p, after[n].detach().to(p.dtype)) for n, p in before.items())
    assert any(name.startswith("epoch_1_") for name in os.listdir(trainer.output_dir))


@pytest.mark.parametrize("overrides, exc, match", [
    (["data.train_llm_hidden_json=hidden.json"], NotImplementedError, "Queue 1 item 11"),
    (["training.optimizer=Muon"], NotImplementedError, "Queue 1 item 8"),
    (["data.augment.host=true"], NotImplementedError, "Queue 1 item 8"),
    (["parallel.n_model=2"], NotImplementedError, "Queue 1 item 12"),
    (["model.classifier_type=bagging"], KeyError, "classifier_type"),
])
def test_unported_baseline_options_raise_before_anything_is_built(tmp_path, overrides, exc, match, monkeypatch):
    _, path = _cli_config(tmp_path)
    built = []
    monkeypatch.setattr(Trainer, "_make_loader", lambda self, split: built.append(split))
    sets = [arg for o in overrides for arg in ("--set", o)]
    with pytest.raises(exc, match=match):
        trun_train.main(["--config", path, "--device", "cpu", *sets])
    assert built == [] or exc is KeyError


def test_bf16_trainer_keeps_the_float32_islands(tmp_path):
    """In a bf16 baseline trainer Mamba's dt_bias, A_log and D, the GroupKAN
    activations' act_coeff and act_base and the BatchNorm affines stay float32
    (the JAX modules use them in float32 arithmetic); every other parameter is
    bf16 with a float32 master; a step runs and moves the islands."""
    paths = write_dataset(tmp_path / "data", n=4)
    cfg = baseline_config(paths, tmp_path, "mamba", "kan", precision="bf16", num_epochs=1)
    pt = Trainer(Config(cfg), "baseline", output_dir=str(tmp_path / "run"), device="cpu")
    f32 = {n for n, p in pt.model.named_parameters() if p.dtype == torch.float32}
    islands = {f"fusion.mamba.{n}" for n in ("dt_bias", "A_log", "D")} | {
        f"classifier.kan{i}.act_{n}" for i in (1, 2) for n in ("coeff", "base")}
    bn = {n for n in f32 if n.startswith("image_encoder.model.") and "bn" in n or "downsample.1" in n}
    assert f32 == islands | bn and islands <= f32
    assert all(p.dtype == torch.bfloat16 for n, p in pt.model.named_parameters() if n not in f32)
    before = {n: p.detach().clone() for n, p in pt.model.named_parameters() if n in islands}
    m = pt.train_step(next(iter(pt.train_loader)))
    assert bool(torch.isfinite(m["loss"]))
    assert all(not torch.equal(p, before[n]) for n, p in pt.model.named_parameters() if n in islands)


def test_stain_and_regrid_options_reach_every_family(tmp_path):
    """data.stain_normalization and training.kan_update_grid_every are the JAX
    Trainer's for every family: MIBF-Net takes the stain pass before its crop, and
    its fit runs with the re-grid on (a model without KAN layers has nothing to
    re-grid, as JAX's empty kan_state)."""
    paths = write_dataset(tmp_path / "data", n=4)
    cfg = train_config(paths, tmp_path, "mibf", num_epochs=1, kan_update_grid_every=1)
    cfg["data"]["stain_normalization"] = {"enabled": True, "target_mean": [140.0, 135.0, 130.0],
                                          "target_std": [15.0, 10.0, 10.0]}
    pt = Trainer(Config(cfg), "mibf", output_dir=str(tmp_path / "run"), device="cpu")
    assert pt.preset.stain == ((140.0, 135.0, 130.0), (15.0, 10.0, 10.0))
    x = torch.randint(0, 256, (2, CANVAS, CANVAS, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    p = taug.sample_crop_flip_rotate(2, CANVAS, torch.Generator().manual_seed(1), vflip=False, degrees=15.0)
    want = taug.apply_crop_flip_rotate(tstain.stain_normalize(x.float() / 255.0, *pt.preset.stain), p, CROP, 15.0)
    torch.testing.assert_close(pt.augment(x, params=p), want.permute(0, 3, 1, 2), rtol=0, atol=0)
    assert pt._kan_regrid(next(iter(pt.train_loader))) == 0
    history = pt.fit()
    assert pt.step == 1 and np.isfinite(history[0]["train_loss"])
