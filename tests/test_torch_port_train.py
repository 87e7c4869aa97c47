"""mdhs_tpu_torch.train against the JAX package, on the CPU in float32.

Losses, schedules and optimizer updates are compared with the JAX functions
on numpy-made inputs; one whole MIBF training step (uint8 canvases ->
augmentation -> training-mode forward -> MP-Loss with the n_valid mask ->
backward -> Adam) with the JAX model, at the sizes of
tests/test_train_step_parity.py::test_mibf_train_step_parity (one BERT layer
768 wide, intermediate 128, vocabulary 128, B = 4, dropout 0) on 72^2
canvases cropped to 64^2. Weights come from the JAX ``init`` (perturbed off
identity) and are carried across with ``mibf_state_dict_from_jax``; the
augmentation's random values are the JAX sampler's own, handed to the port.

Tolerances: losses atol 1e-6 and rtol 1e-6 (float32 of a few terms);
schedules rtol 1e-6
(the JAX schedules evaluate in float32, the port's in float64); optimizer
steps atol 1e-6 (optax and torch take Adam's bias corrections in another
order); the training step: loss atol 1e-4, logits atol 2e-4, per-tower
gradient cosine >= 0.999, BatchNorm running statistics atol 1e-5, as the JAX
package's own differential against torch (with its rtol 1e-3 on logits and
1e-4 on running statistics: torch's BatchNorm sums its variance in float32
in another order, measured 1.0e-5 relative);
post-Adam parameters below.
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdhs_tpu.core.config import load_config
from mdhs_tpu.core.convert import convert_mibf_full
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import mibf as jmibf
from mdhs_tpu.ops.augment import random_crop_flip_rotate
from mdhs_tpu.train import losses as jlosses
from mdhs_tpu.train import optim as joptim
from mdhs_tpu.train.trainer import bert_config_from
from mdhs_tpu_torch.core.convert import mibf_state_dict_from_jax
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import mibf as tmibf
from mdhs_tpu_torch.ops import shear as tshear
from mdhs_tpu_torch.train import losses as tlosses
from mdhs_tpu_torch.train import optim as toptim
from mdhs_tpu_torch.train.metrics import correct_count, masked_accuracy
from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer
from test_torch_port_augment import _jax_sampled_values
from test_torch_port_models import _np_tree, _perturb

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MIBF_BERT = dict(vocab_size=128, hidden_size=768, num_hidden_layers=1, num_attention_heads=12,
                 intermediate_size=128, max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
B, CANVAS, CROP, L, LABELS = 4, 72, 64, 12, 7
LR = 1e-3  # large enough that a post-step difference is not rounding of the update


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- losses
def _logits(seed, n=8):
    rng = np.random.default_rng(seed)
    outs = {k: (rng.normal(size=(n, LABELS)) * s).astype(np.float32)
            for k, s in (("image", 1.5), ("text", 2.0), ("image_text", 3.0))}
    return outs, rng.integers(0, LABELS, n).astype(np.int64)


@pytest.mark.parametrize("smoothing, weighted, masked", [(0.0, False, False), (0.1, False, True),
                                                         (0.02, True, False), (0.1, True, True)])
def test_cross_entropy_matches_jax(smoothing, weighted, masked):
    outs, labels = _logits(1)
    cw = jlosses.compute_class_weights(labels, LABELS)
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32) if masked else None
    kw_j = dict(label_smoothing=smoothing, class_weights=jnp.asarray(cw) if weighted else None,
                sample_mask=None if mask is None else jnp.asarray(mask))
    kw_t = dict(label_smoothing=smoothing, class_weights=_t(cw) if weighted else None,
                sample_mask=None if mask is None else _t(mask))
    ref = jlosses.cross_entropy(jnp.asarray(outs["image"]), jnp.asarray(labels), **kw_j)
    out = tlosses.cross_entropy(_t(outs["image"]), _t(labels), **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_class_weights_and_masked_mean_match_jax():
    labels = np.array([0, 0, 1, 3, 3, 3, 6, 9, -1])
    np.testing.assert_array_equal(tlosses.compute_class_weights(labels, 7),
                                  jlosses.compute_class_weights(labels, 7))
    v = np.random.default_rng(2).normal(size=8).astype(np.float32)
    for mask in (None, np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32), np.zeros(8, np.float32)):
        ref = jlosses.masked_mean(jnp.asarray(v), None if mask is None else jnp.asarray(mask))
        out = tlosses.masked_mean(_t(v), None if mask is None else _t(mask))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("loss_class", ["KL_loss", "textimage_loss", "text_image_textimage_loss"])
@pytest.mark.parametrize("masked", [False, True])
def test_mibf_loss_matches_jax(loss_class, masked):
    outs, labels = _logits(3)
    outs["text"][0] = outs["image"][0] * 40.0  # a row whose probabilities saturate the KL clamp
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32) if masked else None
    ref = jlosses.mibf_loss({k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(labels), loss_class,
                            sample_mask=None if mask is None else jnp.asarray(mask))
    out = tlosses.mibf_loss({k: _t(v) for k, v in outs.items()}, _t(labels), loss_class,
                            sample_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    if loss_class == "KL_loss":
        np.testing.assert_allclose(
            tlosses.kl_divergence(torch.softmax(_t(outs["image"]), -1), torch.softmax(_t(outs["text"]), -1)).numpy(),
            np.asarray(jlosses.kl_divergence(jax.nn.softmax(outs["image"]), jax.nn.softmax(outs["text"]))),
            atol=1e-5, rtol=1e-6)


def test_step_accuracy_is_the_masked_hit_rate():
    outs, labels = _logits(4)
    logits = _t(outs["image_text"])
    hits = (outs["image_text"].argmax(-1) == labels).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    assert math.isclose(float(masked_accuracy(logits, _t(labels))), hits.mean(), rel_tol=1e-6)
    assert math.isclose(float(masked_accuracy(logits, _t(labels), _t(mask))), (hits * mask).sum() / 5, rel_tol=1e-6)
    assert float(correct_count(logits, _t(labels), _t(mask))) == (hits * mask).sum()


# --------------------------------------------------------------------------- schedules, optimizers
@pytest.mark.parametrize("name, kw", [
    ("cosine", dict(num_epochs=30, steps_per_epoch=3)),
    ("cosine", dict(num_epochs=4, steps_per_epoch=1)),
    ("warmup_cosine", dict(num_epochs=10, steps_per_epoch=4, warmup_epochs=3)),
    ("warmup-cosine", dict(num_epochs=2, steps_per_epoch=5, warmup_epochs=5)),
    ("constant", dict(num_epochs=3, steps_per_epoch=2)),
    ("no_such_schedule", dict(num_epochs=3, steps_per_epoch=2)),
    (None, dict(num_epochs=3, steps_per_epoch=2)),
])
def test_schedules_match_jax(name, kw):
    ref = joptim.make_schedule(name, 2e-5, **kw)
    out = toptim.make_schedule(name, 2e-5, **kw)
    for step in range(45):
        np.testing.assert_allclose(out(step), float(ref(step)), rtol=1e-6, atol=1e-6 * 2e-5,
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_optimizer_steps_match_optax(name):
    """Three updates at a changing learning rate, set before each update from
    the schedule at the optimizer's update count (optax's scale_by_learning_rate)."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    kw = dict(num_epochs=2, steps_per_epoch=2, warmup_epochs=1)
    sched_j = joptim.make_schedule("warmup_cosine", 1e-3, **kw)
    sched_t = toptim.make_schedule("warmup_cosine", 1e-3, **kw)
    cfg = {"training": {"weight_decay": 0.01}}
    tx = joptim.make_optimizer(name, sched_j, cfg)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = torch.tensor(p0.copy(), requires_grad=True)
    opt = toptim.make_optimizer(name, [tp], 1e-3, weight_decay=0.01)
    for i, g in enumerate(grads):
        tp.grad = torch.tensor(g)
        toptim.set_learning_rate(opt, sched_t(i))
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-6, rtol=0)


def test_unported_optimizers_raise():
    p = [torch.zeros(2, requires_grad=True)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        toptim.make_optimizer("Muon", p, 1e-3)
    with pytest.raises(ValueError):
        toptim.make_optimizer("Lion", p, 1e-3)


# --------------------------------------------------------------------------- the training step
def _batch(seed, n_valid=None):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int64)
    mask[1, L // 2:] = 0
    b = {"image": rng.integers(0, 256, (B, CANVAS, CANVAS, 3), dtype=np.uint8),
         "input_ids": rng.integers(0, 128, (B, L)).astype(np.int64), "attention_mask": mask,
         "label": rng.integers(0, LABELS, B).astype(np.int64)}
    if n_valid is not None:
        b["n_valid"] = np.int32(n_valid)
    return b


def _preset(**kw):
    return dataclasses.replace(MIBF_HAM_TRAIN, **{**dict(bert=tbert.BertConfig(**MIBF_BERT), batch_size=B, seq_len=L,
                                                          canvas=CANVAS, image_size=CROP, precision="f32"), **kw})


@pytest.fixture(scope="module")
def jax_model():
    model = jmibf.MIBFNet(num_labels=LABELS, bert=jbert.BertConfig(**MIBF_BERT), dtype=jnp.float32)
    b = _batch(0)
    var = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((B, CROP, CROP, 3), jnp.float32),
                              jnp.asarray(b["input_ids"], jnp.int32), jnp.asarray(b["attention_mask"], jnp.int32))
    params, stats = _perturb(_np_tree(var["params"]), _np_tree(var["batch_stats"]), seed=11)
    return model, params, stats


def _grad_tree(model):
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy() for k, p in model.named_parameters()}
    sd.update({k: np.zeros(b.shape, np.float32) for k, b in model.named_buffers()
               if not k.endswith("num_batches_tracked")})
    return convert_mibf_full(sd, num_bert_layers=1)[0]


def _flat_cos(a, b):
    av = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(a)])
    bv = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(b)])
    assert av.shape == bv.shape
    return float(av @ bv / (np.linalg.norm(av) * np.linalg.norm(bv) + 1e-30))


def test_mibf_train_step_matches_jax(jax_model):
    model, params, stats = jax_model
    batch = _batch(1, n_valid=3)  # a short last batch: the fourth row is padding
    key = jax.random.PRNGKey(5)
    sched = joptim.make_schedule("cosine", LR, num_epochs=30, steps_per_epoch=3)
    tx = optax.adam(sched)

    @jax.jit
    def jax_augment(canvases):
        return random_crop_flip_rotate(key, canvases.astype(jnp.float32) / 255.0, CROP, degrees=15.0, vflip=False)

    @jax.jit
    def jax_step(p, images):
        valid = (jnp.arange(B) < batch["n_valid"]).astype(jnp.float32)

        def loss_fn(p):
            out, new_vars = model.apply({"params": p, "batch_stats": stats}, images,
                                        jnp.asarray(batch["input_ids"], jnp.int32),
                                        jnp.asarray(batch["attention_mask"], jnp.int32),
                                        train=True, deterministic=False, rngs={"dropout": key},
                                        mutable=["batch_stats"])
            loss = jlosses.mibf_loss(out, jnp.asarray(batch["label"], jnp.int32), "KL_loss", sample_mask=valid)
            return loss, (new_vars, out)

        (loss, (new_vars, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, out, grads, optax.apply_updates(p, updates), new_vars

    port = tmibf.MIBFNet(LABELS, tbert.BertConfig(**MIBF_BERT))
    port.load_state_dict(mibf_state_dict_from_jax(params, stats), strict=True)
    trainer = Trainer(_preset(learning_rate=LR), model=port, device="cpu", steps_per_epoch=3)
    dev = trainer.to_device(batch)
    valid = trainer.valid_mask(batch, B)
    n = tshear.shear_sublane.launches
    images = trainer.augment(dev["image"], params=_jax_sampled_values(key, B, CANVAS, vflip=False, degrees=15.0))
    assert tshear.shear_sublane.launches == n  # the CPU never launches the kernel
    # 1. the augmentation, from the same canvases and random values
    nhwc = images.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(nhwc, np.asarray(jax_augment(jnp.asarray(batch["image"]))), atol=1e-5, rtol=0)
    # 2. the rest of the step on that one input: train-mode BatchNorm through
    # ResNet50 amplifies the augmentation's 1e-6 differences about 100-fold
    # (the JAX model's own logits move 5e-4 between the two images)
    loss_j, out_j, grads_j, params_j, vars_j = jax_step(params, jnp.asarray(nhwc))
    loss_t, out_t = trainer.forward_backward(images, dev, valid)

    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-4, rtol=0)
    for k in ("image_text", "text", "image"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=2e-4, rtol=1e-3, err_msg=k)
    grads_t = _grad_tree(trainer.model)
    for tower in ("image_encoder", "text_encoder", "textbased_cross_attention", "imagbased_cross_attention"):
        c = _flat_cos(grads_j[tower], grads_t[tower])
        assert c >= 0.999, f"{tower} grad cosine {c}"
    heads = ("fc", "fc_image_hidden", "fc_image_out", "fc_text_hidden", "fc_text_out")
    c = _flat_cos([grads_j[h] for h in heads], [grads_t[h] for h in heads])
    assert c >= 0.999, f"heads grad cosine {c}"

    trainer.optimizer_step()
    sd = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    new_params, new_stats = convert_mibf_full(sd, num_bert_layers=1)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(vars_j["batch_stats"])[0],
                            jax.tree_util.tree_leaves(new_stats)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=1e-4, err_msg=jax.tree_util.keystr(path))
    # Adam's first update is lr * g / (|g| + eps): lr * sign(g) wherever |g| >> eps.
    # Where the two gradients agree in sign the steps agree to rounding; where a
    # gradient sits at the noise floor (ReLU masks flipped by 1e-6 forward
    # differences, see tests/test_train_step_parity.py:329-338) the sign may
    # differ, moving that parameter by up to 2 lr.
    dj = np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(params_j)])
    dt = np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(new_params)])
    delta = np.abs(dt - dj)
    assert delta.max() <= 2 * LR * (1 + 1e-4)
    assert np.mean(delta <= 1e-3 * LR) >= 0.99, np.mean(delta <= 1e-3 * LR)
    assert trainer.step == 1


def test_trainer_fit_two_epochs_on_the_cpu():
    preset = _preset(learning_rate=2e-5)
    trainer = Trainer(preset, device="cpu")
    train = [_batch(10 + i, n_valid=B if i < 2 else 2) for i in range(3)]  # the last batch is short
    val = [_batch(20, n_valid=B), _batch(21, n_valid=3)]
    before = [p.detach().clone() for p in trainer.master_parameters()]
    history = trainer.fit(train, val, num_epochs=2)
    assert [h["epoch"] for h in history] == [1, 2] and [h["steps"] for h in history] == [3, 6]
    assert trainer.step == 6
    for h in history:
        assert len(h["train_losses"]) == 3 and all(math.isfinite(x) for x in h["train_losses"])
        assert math.isfinite(h["val_loss"]) and 0.0 <= h["val_acc"] <= 100.0
    # the epoch-stepped cosine of 30 epochs over 3 steps an epoch, read after each epoch
    for h in history:
        want = 2e-5 * 0.5 * (1 + math.cos(math.pi * (h["steps"] // 3) / 30))
        assert math.isclose(h["lr"], want, rel_tol=1e-12)
    assert any(not torch.equal(a, b) for a, b in zip(before, trainer.master_parameters()))
    bn = trainer.model.image_encoder.bn1
    assert int(bn.num_batches_tracked) == 6 and bn.running_var.dtype == torch.float32


def test_bf16_working_module_keeps_float32_masters_and_batchnorm():
    trainer = Trainer(_preset(precision="bf16"), device="cpu")
    model = trainer.model
    for name, p in model.named_parameters():
        want = torch.float32 if ".bn" in name or "downsample.1" in name or name.startswith("image_encoder.bn1") \
            else torch.bfloat16
        assert p.dtype == want, name
    assert all(m.dtype == torch.float32 for m in trainer.master_parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers() if "running" in n)
    m = trainer.train_step(_batch(30, n_valid=B))
    assert math.isfinite(float(m["loss"])) and 0.0 <= float(m["accuracy"]) <= 1.0
    # the working weights are the masters rounded to bf16 after the step
    for (p, master) in zip(model.parameters(), trainer.master_parameters()):
        torch.testing.assert_close(p, master.to(p.dtype), atol=0, rtol=0)


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken (checked on the card by chip_smoke.py)")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer()


def test_trainer_rejects_unported_optimizer_and_unknown_precision():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(_preset(optimizer="Muon"), device="cpu")
    with pytest.raises(ValueError, match="precision"):
        Trainer(_preset(precision="fp8"), device="cpu")


def test_train_preset_is_the_yaml_resolution():
    """MIBF_HAM_TRAIN = configs/mibf/mibf_ham.yml over configs/common/base.yml,
    read as mdhs_tpu.train.trainer.Trainer reads it for family="mibf"."""
    cfg = load_config(REPO / "configs" / "mibf" / "mibf_ham.yml")
    t = cfg.get("training", {})
    aug = cfg.get("data.augment", {}) or {}
    p = MIBF_HAM_TRAIN
    assert dataclasses.asdict(p.bert) == dataclasses.asdict(bert_config_from(cfg, vocab_size=30522))
    assert p.num_labels == cfg.get("model.num_classes") == 7
    assert p.batch_size == int(cfg.get("training.batch_size", 32)) == 32
    assert p.seq_len == cfg.get("tokenizer.max_length") == 256
    assert p.canvas == int(cfg.get("data.canvas", 256)) and p.image_size == int(cfg.get("data.image_size", 224))
    assert p.learning_rate == float(t.get("learning_rate", 1e-4)) == 2e-5
    assert p.num_epochs == int(t.get("num_epochs", 1)) == 30
    assert p.optimizer == str(t.get("optimizer", "Adam")) and p.lr_scheduler == t.get("lr_scheduler")
    assert p.warmup_epochs == t.get("warmup_epochs", 5)
    assert p.weight_decay == float(t.get("weight_decay", 0.01))
    assert p.loss_class == cfg.get("model.loss_class", "KL_loss")
    assert p.degrees == aug.get("degrees", 15.0) and p.vflip == bool(aug.get("vflip", False))
    assert p.seed == int(t.get("seed", 0)) and p.precision == cfg.get("training.precision", "bf16")


@pytest.mark.parametrize("what, asks", [
    ("host augmentation", lambda cfg, t, aug: bool(aug.get("host", False))),
    ("colour jitter", lambda cfg, t, aug: bool(aug.get("color_jitter", False))),
    ("stain normalisation",
     lambda cfg, t, aug: bool((cfg.get("data.stain_normalization", {}) or {}).get("enabled", False))),
    ("supcon", lambda cfg, t, aug: bool((t.get("supcon", {}) or {}).get("enabled", False))),
    ("remat", lambda cfg, t, aug: str(t.get("remat", "none")) != "none"),
    ("encoder freezing", lambda cfg, t, aug: bool(cfg.get("model.image_encoder.freeze", False)
                                                  or cfg.get("model.text_encoder.freeze", False))),
    ("the flattened optimizer", lambda cfg, t, aug: bool(t.get("flatten_optimizer", False))),
    ("KAN re-gridding", lambda cfg, t, aug: int(t.get("kan_update_grid_every", 0) or 0) != 0),
])
def test_mibf_ham_asks_for_nothing_the_port_lacks(what, asks):
    """TrainPreset has no field for these (the family is run_train_mibf.py's
    --family mibf); the YAML the preset resolves asks for none of them."""
    cfg = load_config(REPO / "configs" / "mibf" / "mibf_ham.yml")
    assert not asks(cfg, cfg.get("training", {}), cfg.get("data.augment", {}) or {}), what
