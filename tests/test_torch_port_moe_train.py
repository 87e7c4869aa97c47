"""ConNexT's training-side MoE against the JAX package, on the CPU in float32:
the noisy top-k gating with its load estimator, the MoE's training forward
and balance loss, and ``kan_forward``'s gradients through the
``torch.ops.mdhs.kan_forward`` autograd.

The gating noise is the JAX side's, handed to the port (``noise=``; the
JAX MoE's draw is swapped for it by monkeypatching the module-level
``noisy_top_k_gating`` the JAX ``MoE`` calls; nothing in ``mdhs_tpu``
changes). Gradients on the JAX side come from ``jax.vjp``.

Tolerances: gates, load and balance atol 1e-6 (float32 softmax and erf of
order-1 values); their gradients atol 1e-5 * max |ref| (float32 sums in
another order); ``kan_forward``'s gradients max |d| <= 1e-5 * max |ref|, as
its forward in ``tests/test_torch_port_kan.py``; the MoE's logits atol 2e-5
and its parameter gradients 1e-5 * max |ref|.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.modules import moe as jmoe
from mdhs_tpu.ops import kan_spline as jks
from mdhs_tpu_torch.core.convert import moe_state_dict_from_jax
from mdhs_tpu_torch.modules import moe as tmoe
from mdhs_tpu_torch.ops import kan_spline as tks
from test_torch_port_kan import _perturb, kan_inputs

torch.set_num_threads(2)
T = torch.from_numpy


def _close(out, ref, frac):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    d = np.abs(out - ref).max()
    assert d <= frac * max(np.abs(ref).max(), 1e-30), (d, np.abs(ref).max())


def _gating_inputs(seed, B=9, D=16, E=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, D)).astype(np.float32), (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
            (rng.standard_normal((D, E)) * 0.3).astype(np.float32), rng.standard_normal((B, E)).astype(np.float32))


# --------------------------------------------------------------------------- the gating
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("load_mode", ["consistent", "reference"])
def test_noisy_gating_and_its_gradients_match_jax(load_mode, k):
    x, wg, wn, noise = _gating_inputs(10 + k)

    def jfn(x, wg, wn):
        gates, load = jmoe.noisy_top_k_gating(x, wg, wn, k, train=True, load_mode=load_mode, noise=jnp.asarray(noise))
        return gates, load, jmoe.cv_squared(gates.sum(0)) + jmoe.cv_squared(load)

    (jg, jl, jb), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, wg, wn)))
    rng = np.random.default_rng(k)
    cot = [rng.standard_normal(np.shape(a)).astype(np.float32) for a in (jg, jl, jb)]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cot))

    leaves = [T(a).clone().requires_grad_() for a in (x, wg, wn)]
    gates, load = tmoe.noisy_top_k_gating(*leaves, k, train=True, load_mode=load_mode, noise=T(noise))
    balance = tmoe.cv_squared(gates.sum(0)) + tmoe.cv_squared(load)
    for out, ref in ((gates, jg), (load, jl), (balance, jb)):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    assert (gates > 0).sum(1).eq(k).all()
    assert not torch.equal(load, (gates > 0).float().sum(0))  # the differentiable estimate, not the count
    torch.autograd.backward([gates, load, balance], [T(c) for c in cot])
    for name, leaf, ref in zip(("x", "w_gate", "w_noise"), leaves, jgrads):
        _close(leaf.grad.numpy(), ref, 1e-5)


def test_gating_draws_from_the_generator_it_is_given():
    x, wg, wn, _ = _gating_inputs(3)
    draw = lambda seed: tmoe.noisy_top_k_gating(T(x), T(wg), T(wn), 2, train=True,  # noqa: E731
                                                generator=torch.Generator().manual_seed(seed))
    (g1, l1), (g2, _), (g3, _) = draw(0), draw(0), draw(1)
    assert torch.equal(g1, g2) and not torch.equal(g1, g3)
    noise = torch.randn((9, 4), generator=torch.Generator().manual_seed(0))
    g4, l4 = tmoe.noisy_top_k_gating(T(x), T(wg), T(wn), 2, train=True, noise=noise)
    assert torch.equal(g1, g4) and torch.equal(l1, l4)


def test_unknown_load_mode_raises():
    x, wg, wn, noise = _gating_inputs(4)
    with pytest.raises(ValueError, match="load_mode"):
        tmoe.noisy_top_k_gating(T(x), T(wg), T(wn), 2, train=True, noise=T(noise), load_mode="mixed")


# --------------------------------------------------------------------------- kan_forward's autograd
@pytest.mark.parametrize("case", ["layer", "bank", "bank_shared_x"])
def test_kan_forward_gradients_match_jax_vjp(case):
    """The op's backward is the VJP of the plain version for x, base_w, spline_w
    (``mdhs_tpu/ops/kan_spline.py::_bwd``), and none for the grid."""
    E = None if case == "layer" else 3
    x, grid, bw, sw = kan_inputs(5, 12, 9, seed=40, E=E)
    if case == "bank_shared_x":
        x = x[0]
    g = np.random.default_rng(41).standard_normal((5, 9) if E is None else (E, 5, 9)).astype(np.float32)

    def jfn(x, bw, sw):
        if E is None:
            return jks.kan_forward(x, jnp.asarray(grid), bw, sw, 3)
        in_x = None if case == "bank_shared_x" else 0
        return jax.vmap(lambda xe, ge, be, se: jks.kan_forward(xe, ge, be, se, 3),
                        in_axes=(in_x, 0, 0, 0))(x, jnp.asarray(grid), bw, sw)

    ref, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, bw, sw)))
    jdx, jdbw, jdsw = vjp(jnp.asarray(g))
    leaves = [T(a).clone().requires_grad_() for a in (x, bw, sw)]
    tgrid = T(grid).clone().requires_grad_()
    n = tks.kan_forward.launches
    out = tks.kan_forward(leaves[0], tgrid, leaves[1], leaves[2], 3)
    _close(out.detach().numpy(), ref, 1e-5)
    out.backward(T(g))
    assert tks.kan_forward.launches == n  # a CPU tensor takes the plain version, backward too
    for leaf, r in zip(leaves, (jdx, jdbw, jdsw)):
        _close(leaf.grad.numpy(), r, 1e-5)
    assert tgrid.grad is None  # the grid takes no gradient, as in JAX's custom VJP


# --------------------------------------------------------------------------- the MoE's training forward
@pytest.fixture(scope="module")
def moe_pair():
    x = (np.random.default_rng(7).standard_normal((6, 16)) * 0.8).astype(np.float32)
    jmod = jmoe.MoE(input_size=16, output_size=7, num_experts=4, k=2, expert_layers=(16, 24, 7), dtype=jnp.float32)
    var = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params, state = _perturb(var["params"], 8), var["kan_state"]
    params["w_noise"] = np.asarray(params["w_noise"]) + np.random.default_rng(9).standard_normal((16, 4)) * 0.2
    mod = tmoe.MoE(16, 7, 4, 2, expert_layers=(16, 24, 7))
    mod.load_state_dict(moe_state_dict_from_jax(params, state), strict=True)
    return jmod, params, state, mod, x


def test_moe_training_forward_and_gradients_match_jax(moe_pair, monkeypatch):
    jmod, params, state, mod, x = moe_pair
    noise = np.random.default_rng(12).standard_normal((6, 4)).astype(np.float32)
    real = jmoe.noisy_top_k_gating
    monkeypatch.setattr(jmoe, "noisy_top_k_gating",
                        lambda *a, **kw: real(*a, **{**kw, "noise": jnp.asarray(noise)}))
    cot = np.random.default_rng(13).standard_normal((6, 7)).astype(np.float32)

    def jloss(p):
        y, balance = jmod.apply({"params": p, "kan_state": state}, jnp.asarray(x), train=True,
                                rngs={"gating": jax.random.PRNGKey(0)})
        return (y * cot).sum() + balance, (y, balance)

    (jl, (jy, jb)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    mod.zero_grad(set_to_none=True)
    y, balance = mod(T(x), train=True, noise=T(noise))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=2e-5, rtol=0)
    np.testing.assert_allclose(balance.item(), float(jb), atol=1e-6, rtol=1e-5)
    ((y * T(cot)).sum() + balance).backward()
    got = moe_state_dict_from_jax({k: v for k, v in jax.tree_util.tree_map(np.asarray, jgrads).items()}, state)
    for name, p in mod.named_parameters():
        _close(p.grad.numpy(), got[name].numpy(), 1e-5)
    assert all(p.grad.abs().sum() > 0 for n, p in mod.named_parameters() if n.startswith("experts."))


def test_moe_training_forward_needs_its_generator(moe_pair):
    *_, mod, x = moe_pair
    with pytest.raises(ValueError, match="generator"):
        mod(T(x), train=True)
    y1, b1 = mod(T(x), train=True, generator=torch.Generator().manual_seed(5))
    y2, b2 = mod(T(x), train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(y1, y2) and torch.equal(b1, b2)


# --------------------------------------------------------------------------- ConNexT: the JAX Trainer and the port's
import test_torch_port_connext  # noqa: E402  registers the pico ConvNeXt in both packages
from mdhs_tpu.core.config import Config as JConfig  # noqa: E402
from mdhs_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from mdhs_tpu_torch.core.config import Config  # noqa: E402
from mdhs_tpu_torch.core.convert import connext_state_dict_from_jax  # noqa: E402
from mdhs_tpu_torch.models.convnext import ConvNeXt  # noqa: E402
from mdhs_tpu_torch.models.init import init_parameters  # noqa: E402
from mdhs_tpu_torch.ops import augment as taug  # noqa: E402
from mdhs_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_port_augment import _jax_sampled_values  # noqa: E402
from test_torch_port_train_cli import (B, CANVAS, _hf_bert_file, carry_weights, flat_cos, jax_batch,  # noqa: E402
                                       no_dropout, train_config, write_dataset)


def _hf_convnext_file(path, seed):
    """A ConvNextForImageClassification-style state dict (``convnext.`` prefix, the final
    layernorm and a classifier, which the loaders drop) from a seeded pico tower."""
    tower = init_parameters(ConvNeXt("port_pico"), torch.Generator().manual_seed(seed))
    sd = {"convnext." + k: v.clone() for k, v in tower.state_dict().items()}
    for k in sd:
        if k.endswith("layer_scale_parameter"):  # off their 1e-6 init, so that the blocks show
            sd[k].uniform_(0.3, 1.0, generator=torch.Generator().manual_seed(len(k)))
    sd.update({"convnext.layernorm.weight": torch.ones(40), "convnext.layernorm.bias": torch.zeros(40),
               "classifier.weight": torch.zeros(1000, 40), "classifier.bias": torch.zeros(1000)})
    torch.save(sd, path)
    return sd


@pytest.fixture(scope="module")
def connext_pair(tmp_path_factory):
    """The JAX and the port Trainer from one connext config naming pretrained towers."""
    root = tmp_path_factory.mktemp("train_connext")
    cfg = train_config(write_dataset(root / "data"), root, "connext")
    cfg["model"]["image_encoder"]["pretrained_path"] = str(root / "convnext.safetensors.pt")
    cfg["model"]["text_encoder"]["pretrained_path"] = str(root / "bert.pt")
    files = {"image": _hf_convnext_file(cfg["model"]["image_encoder"]["pretrained_path"], 15),
             "text": _hf_bert_file(cfg["model"]["text_encoder"]["pretrained_path"], cfg, 16, rooted=False)}
    jt = JTrainer(JConfig(cfg), family="connext", output_dir=str(root / "jax_run"))
    pt = Trainer(Config(cfg), "connext", output_dir=str(root / "port_run"), device="cpu")
    return {"root": root, "cfg": cfg, "jax": jt, "port": pt, "files": files}


def _jax_state_dict(jt):
    return connext_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params),
                                       jax.tree_util.tree_map(np.asarray, jt.state.kan_state))


@pytest.mark.parametrize("tower", ["image", "text"])
def test_connext_pretrained_towers_load_as_the_jax_trainer_loads_them(connext_pair, tower):
    """An HF ConvNeXt (``convnext.`` prefix; its final layernorm and classifier
    dropped) and an HF BertModel (``embeddings.`` rooted; its pooler dropped): the
    same parameters through the port's loader as through JAX's convert_convnext_any
    / convert_bert, and the file's values."""
    jsd, tsd = _jax_state_dict(connext_pair["jax"]), connext_pair["port"].state_dict()
    prefix, key = (("image_encoder.", lambda k: "convnext." + k[len("image_encoder."):]) if tower == "image"
                   else ("text_encoder.bert.", lambda k: k[len("text_encoder.bert."):]))
    names = [k for k in tsd if k.startswith(prefix)]
    assert names
    sd = connext_pair["files"][tower]
    for k in names:
        assert torch.equal(tsd[k], jsd[k]) and torch.equal(tsd[k], sd[key(k)].float()), k


def test_connext_train_step_matches_the_jax_trainer(connext_pair, monkeypatch):
    """One ConNexT step of the config-driven Trainer against the JAX Trainer's loss
    function on the same weights, batch (its padded tail masked), augmented images
    (the JAX sampler's crop, flips, rotation and jitter factors, handed to the port)
    and gating noise: the images atol 1e-5, the loss (class-weighted CE + 0.05 x
    balance) rtol 1e-5, the logits atol 2e-4 / rtol 1e-3, each tower's gradient
    cosine >= 0.9999 and each parameter's gradient within 1e-4 x the largest |ref|."""
    jt, pt, root = connext_pair["jax"], connext_pair["port"], connext_pair["root"]
    no_dropout(jt, pt)
    carry_weights(jt, pt, test_torch_port_connext._perturb(jax.tree_util.tree_map(np.asarray, jt.state.params), 31),
                  root)
    batch = list(pt.val_loader)[-1]
    assert int(batch["n_valid"]) == 2
    key = jax.random.PRNGKey(4)
    k_aff, k_col = jax.random.split(key)
    jimages = np.asarray(jt._preprocess_train(key, jnp.asarray(batch["image"])), np.float32)
    kb, kc, ks, kh = jax.random.split(k_col, 4)
    f = [jax.random.uniform(k_, (B, 1, 1, 1), minval=0.8, maxval=1.2) for k_ in (kb, kc, ks)]
    f.append(jax.random.uniform(kh, (B, 1, 1), minval=-0.1, maxval=0.1))
    jitter = taug.ColorJitter(*(torch.from_numpy(np.asarray(a).reshape(B).copy()) for a in f))
    dev = pt.to_device(batch)
    timages = pt.augment(dev["image"], params=_jax_sampled_values(k_aff, B, CANVAS, vflip=True, degrees=45.0),
                         jitter=jitter)
    np.testing.assert_allclose(timages.permute(0, 2, 3, 1).numpy(), jimages, atol=1e-5, rtol=0)

    noise = np.random.default_rng(33).standard_normal((B, 4)).astype(np.float32)
    real = jmoe.noisy_top_k_gating
    monkeypatch.setattr(jmoe, "noisy_top_k_gating", lambda *a, **kw: real(*a, **{**kw, "noise": jnp.asarray(noise)}))
    grad_fn = jax.value_and_grad(jt._loss_fn, has_aux=True)
    (jloss, (_, jlogits)), jgrads = grad_fn(jt.state.params, jt.state.batch_stats, jt.state.kan_state,
                                            jax_batch(batch), jnp.asarray(jimages), key)
    images = torch.from_numpy(jimages.copy()).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    loss, out = pt.forward_backward(images, dev, pt.valid_mask(batch, B), noise=T(noise))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jlogits), atol=2e-4, rtol=1e-3)
    assert out["balance"].item() > 0
    jg = connext_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                     jax.tree_util.tree_map(np.asarray, jt.state.kan_state))
    tg = {n: p.grad for n, p in pt.model.named_parameters()}
    scale = max(float(v.abs().max()) for v in jg.values())
    for n, g in tg.items():
        assert g is not None, n
        assert float((g - jg[n]).abs().max()) <= 1e-4 * scale, (n, float((g - jg[n]).abs().max()), scale)
    for tower in ("image_encoder", "text_encoder", "moe"):
        names = [n for n in tg if n.split(".")[0] == tower]
        c = flat_cos([tg[n].numpy() for n in names], [jg[n].numpy() for n in names])
        assert c >= 0.9999, (tower, c)


def test_connext_validate_matches_the_jax_trainer(connext_pair):
    """validate(): the eval forward (clean gating, ImageNet normalisation) and the
    training criterion with the class weights, without the balance loss."""
    jt, pt = connext_pair["jax"], connext_pair["port"]
    carry_weights(jt, pt, jt.state.params, connext_pair["root"])
    jloss, jacc = jt.validate()
    tloss, tacc = pt.validate()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert tacc == jacc


def test_connext_fit_writes_the_run_and_its_kernels_path(connext_pair, tmp_path):
    """Two epochs of the port's fit: finite losses, parameters moved, JAX's tags in
    metrics.jsonl, the per-class report under training.log_per_class, and the
    checkpoints (at most 3, best first, and last.pt)."""
    cfg = Config(connext_pair["cfg"]).merged({"training": {"log_per_class": True, "log_every": 1}})
    pt = Trainer(cfg, "connext", output_dir=str(tmp_path), device="cpu")
    before = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    history = pt.fit()
    assert [h["epoch"] for h in history] == [1, 2] and pt.step == 6
    assert all(np.isfinite(h["train_losses"]).all() and np.isfinite(h["val_loss"]) for h in history)
    moved = [n for n, p in pt.model.named_parameters() if not torch.equal(p, before[n])]
    assert any(n.startswith("moe.experts.") for n in moved) and any(n.startswith("image_encoder.") for n in moved)
    tags = [json.loads(line)["tag"] for line in open(tmp_path / "metrics.jsonl")]
    for tag in ("Loss/Train_Batch", "Loss/Train_Epoch", "Loss/Validation", "Accuracy/Validation", "LearningRate",
                "val/accuracy_macro", "val/auroc_macro", "per_class/f1_class_6"):
        assert tag in tags, tag
    assert tags.count("Loss/Train_Batch") == 6
    index = json.load(open(tmp_path / "checkpoints.json"))
    assert 1 <= len(index) <= 3 and index == sorted(index, key=lambda e: -e["metric"])
    assert (tmp_path / "last.pt").exists()


def test_connext_kan_regrid_matches_the_jax_trainer(connext_pair):
    """training.kan_update_grid_every reaches ConNexT's bank by the baseline's code:
    Trainer._kan_regrid on one batch against the JAX Trainer's on the same weights,
    each expert's grid and spline weight within 1e-3 of max |ref| (the inputs come
    through the whole eval forward; tests/test_torch_port_baseline_train.py holds
    the refit itself to 1e-4 on equal inputs)."""
    jt, pt = connext_pair["jax"], connext_pair["port"]
    carry_weights(jt, pt, jt.state.params, connext_pair["root"])
    batch = next(iter(pt.train_loader))
    jt._kan_regrid(jax_batch(batch))
    assert pt._kan_regrid(batch) == 2
    want = _jax_state_dict(jt)
    got = pt.state_dict()
    names = [k for k in got if k.startswith("moe.experts.") and k.rsplit(".", 1)[1] in ("grid", "spline_weight")]
    assert len(names) == 4 * 2 * 2
    for k in names:
        _close(got[k].detach().numpy(), want[k].numpy(), 1e-3)
