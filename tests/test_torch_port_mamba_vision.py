"""MambaVision of mdhs_tpu_torch against the JAX package's, on the CPU in
float32: the window partition, the mixer, the attention, the blocks, the
taps and ``classify``, a layer-scale variant, the baseline model with a
``mamba_vision_*`` tower in the three ablation modes and one training
step's gradients, the converters both ways, and ``ham_mamba_vision_v1.json``.

Both packages' zoos take two tiny variants for the module's tests (as
tests/test_mamba_vision_parity.py registers its own): width 16, depths (1, 1,
3, 2), windows (4, 4, 3, 3), so that at 64 x 64 (maps 4 x 4 and 2 x 2 in
stages 3 and 4) every token stage pads; ``TINY_LS`` with a layer scale. The
JAX init's weights, every BatchNorm statistic and affine, bias, ``A_log``,
``D``, ``dt_proj_bias`` and layer scale moved off its init, are carried across
by ``mamba_vision_state_dict_from_jax``. Outputs within atol 2e-4, rtol 1e-3
(the float32 tolerance of tests/test_torch_port_baseline.py); gradients
within a cosine of 0.9999 a tower.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.core.config import load_config
from mdhs_tpu.core.convert import convert_mamba_vision
from mdhs_tpu.models import baseline as jbase
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import mamba_vision as jmv
from mdhs_tpu_torch.core import config as tconfig
from mdhs_tpu_torch.core.convert import baseline_state_dict_from_jax, mamba_vision_state_dict_from_jax
from mdhs_tpu_torch.models import baseline as tbase
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import mamba_vision as tmv
from mdhs_tpu_torch.models import model_config

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
TINY = dict(dim=16, in_dim=8, depths=(1, 1, 3, 2), heads=(2, 2, 2, 4), window=(4, 4, 3, 3), layer_scale=None)
SPECS = {"TINY": TINY, "TINY_LS": dict(TINY, layer_scale=1e-5)}
BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def tiny_zoo():
    with pytest.MonkeyPatch.context() as mp:
        for name, spec in SPECS.items():
            mp.setitem(jmv.MAMBA_VISION_SPECS, name, spec)
            mp.setitem(tmv.MAMBA_VISION_SPECS, name, spec)
        yield


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("bias", "mean", "dt_proj_bias"):
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name in ("scale", "var", "D"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        if name == "A_log":
            return (a + rng.uniform(-0.3, 0.3, a.shape)).astype(np.float32)
        if name in ("gamma_1", "gamma_2"):  # the layer scale's 1e-5 would hide every block
            return rng.uniform(0.3, 0.7, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _images(seed, n=2, hw=(64, 64)):
    return np.random.default_rng(seed).normal(size=(n, *hw, 3)).astype(np.float32)  # NHWC


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@functools.lru_cache(maxsize=None)
def tower(variant):
    """(JAX MambaVision with a head, its perturbed variables as numpy, the port's with the same weights)."""
    jm = jmv.MambaVision(variant=variant, num_classes=5, dtype=jnp.float32)
    var = jax.jit(functools.partial(jm.init, features_only=False))(jax.random.PRNGKey(0), jnp.asarray(_images(0)))
    var = {k: jax.tree_util.tree_map(np.asarray, _perturb(var[k], i)) for i, k in enumerate(("params", "batch_stats"))}
    tm = tmv.MambaVision(variant, num_classes=5, head=True).eval()
    tm.load_state_dict(mamba_vision_state_dict_from_jax(var["params"], var["batch_stats"]), strict=False)
    assert set(tm.state_dict()) - set(mamba_vision_state_dict_from_jax(var["params"], var["batch_stats"])) == {
        k for k in tm.state_dict() if k.endswith("num_batches_tracked")}
    return jm, var, tm


@pytest.mark.parametrize("shape, ws", [((2, 6, 6, 4), 3), ((1, 4, 8, 5), 2), ((3, 14, 14, 2), 7)])
def test_window_partition_matches_jax_and_round_trips(shape, ws):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = tmv.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmv.window_partition(jnp.asarray(x), ws)))
    back = tmv.window_reverse(got, ws, shape[1], shape[2])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jmv.window_reverse(jnp.asarray(got.numpy()), ws,
                                                                               shape[1], shape[2])))


def test_transformer_block_indices_and_specs_match_jax():
    for d in range(1, 21):
        assert list(tmv.transformer_block_indices(d)) == list(jmv.transformer_block_indices(d))
    assert {k: v for k, v in tmv.MAMBA_VISION_SPECS.items() if k not in SPECS} == \
        {k: v for k, v in jmv.MAMBA_VISION_SPECS.items() if k not in SPECS}
    assert tmv.stage_widths("T") == {"layer1": 80, "layer2": 160, "layer3": 320, "layer4": 640}


# stage 3's blocks: 0 and 1 mixers, 2 attention (transformer_block_indices(3) = [2])
@pytest.mark.parametrize("variant", list(SPECS))
@pytest.mark.parametrize("part", ["mixer", "attention", "mixer_block", "attention_block"])
def test_token_stage_parts_match_jax(variant, part):
    jm, var, tm = tower(variant)
    dim, heads = 4 * TINY["dim"], TINY["heads"][2]
    x = np.random.default_rng(2).normal(size=(3, 9, dim)).astype(np.float32)
    block = 0 if part.startswith("mixer") else 2
    p = var["params"][f"s2_block{block}"]
    if part == "mixer":
        ref = jmv.MambaVisionMixer(dim, dtype=jnp.float32).apply({"params": p["mixer"]}, jnp.asarray(x))
        mod = tm.levels[2].blocks[0].mixer
    elif part == "attention":
        ref = jmv.Attention(dim, heads, dtype=jnp.float32).apply({"params": p["attn"]}, jnp.asarray(x))
        mod = tm.levels[2].blocks[2].mixer
    else:
        jb = jmv.Block(dim, heads, use_attention=block == 2, layer_scale=SPECS[variant]["layer_scale"],
                       dtype=jnp.float32)
        ref = jb.apply({"params": p}, jnp.asarray(x))
        mod = tm.levels[2].blocks[block]
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("variant", list(SPECS))
@pytest.mark.parametrize("hw", [(64, 64), (56, 72)])
def test_taps_and_classify_match_jax(variant, hw):
    """Every tap (NCHW against JAX's NHWC) and the logits; at 64 x 64 stages 3 and 4
    pad 4 x 4 to 6 x 6 and 2 x 2 to 3 x 3, at 56 x 72 both axes differ."""
    jm, var, tm = tower(variant)
    img = _images(3, hw=hw)
    _, taps = jax.jit(functools.partial(jm.apply, return_taps=True))(var, jnp.asarray(img))
    logits = jax.jit(functools.partial(jm.apply, method=jm.classify))(var, jnp.asarray(img))
    with torch.no_grad():
        got = tm(_nchw(img))
        out = tm.classify(_nchw(img))
    assert list(got) == ["stem", "layer1", "layer2", "layer3", "layer4"]
    for k, v in got.items():
        np.testing.assert_allclose(v.permute(0, 2, 3, 1).numpy(), np.asarray(taps[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(out.numpy(), np.asarray(logits), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("variant", list(SPECS))
def test_convert_mamba_vision_reads_the_port_state_dict_bit_for_bit(variant):
    """``convert_mamba_vision`` of the port's state_dict gives the JAX trees exactly,
    and ``mamba_vision_state_dict_from_jax`` of those gives the state_dict back."""
    _, var, tm = tower(variant)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params, stats = convert_mamba_vision(sd, variant=variant)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    for got, want in ((params, var["params"]), (stats, var["batch_stats"])):
        g, w = flat(got), flat(want)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    back = mamba_vision_state_dict_from_jax(params, stats)
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        assert torch.equal(v, torch.from_numpy(sd[k])), k


def test_port_init_is_flaxs():
    """init_parameters: A_log log(1..N), D 1, dt_proj's bias the inverse softplus of
    a step in [1e-3, 1e-1], the layer scale, kernels at 1/sqrt(fan_in)."""
    from mdhs_tpu_torch.models.init import init_parameters

    tm = init_parameters(tmv.MambaVision("TINY_LS"), torch.Generator().manual_seed(0))
    mixer = tm.levels[2].blocks[0].mixer
    want = np.tile(np.log(np.arange(1, 9, dtype=np.float32)), (32, 1))  # _a_log_init's numpy log
    assert np.array_equal(mixer.A_log.detach().numpy(), want)
    assert torch.equal(mixer.D, torch.ones(32))
    dt = torch.nn.functional.softplus(mixer.dt_proj.bias.detach())
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 1e-1 * 1.001
    assert torch.equal(tm.levels[3].blocks[1].gamma_2, torch.full((128,), 1e-5))
    std = float(mixer.conv1d_x.weight.std())
    assert 0.3 < std * 3 ** 0.5 < 1.7  # 1 / sqrt(3): the kernel's 3 taps


# --- the baseline with a MambaVision tower ---------------------------------------------------------
def _cfg(module, variant="TINY"):
    return module.BaselineConfig(num_classes=7, hidden_dim=32, text_feature_dim=32, num_heads=4, dropout=0.0,
                                 fusion_type="basic", classifier_type="mlp", image_backbone=f"mamba_vision_{variant}",
                                 bert=(jbert if module is jbase else tbert).BertConfig(**BERT))


def _text(seed, n=2, L=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (n, L)).astype(np.int64)
    mask = np.ones((n, L), np.int64)
    mask[0, 6:] = 0
    return ids, mask


@functools.lru_cache(maxsize=None)
def baseline_pair(variant="TINY"):
    jmodel = jbase.MultimodalBaselineModel(_cfg(jbase, variant), dtype=jnp.float32)
    ids, mask = _text(0)
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(_images(0)), jnp.asarray(ids, jnp.int32),
                               jnp.asarray(mask, jnp.int32))
    var = {k: jax.tree_util.tree_map(np.asarray, _perturb(var[k], seed=i))
           for i, k in enumerate(("params", "batch_stats"))}
    model = tbase.MultimodalBaselineModel(_cfg(tbase, variant)).eval()
    model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], None, "basic", "mlp"),
                          strict=False)
    return jmodel, var, model


@pytest.mark.parametrize("ablation_mode", [None, "image_only", "text_off"])
def test_baseline_with_a_mamba_vision_tower_matches_jax(ablation_mode):
    jmodel, var, model = baseline_pair()
    img, (ids, mask) = _images(4), _text(5)
    ref = jax.jit(functools.partial(jmodel.apply, ablation_mode=ablation_mode))(
        var, jnp.asarray(img), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        out = model(_nchw(img), torch.from_numpy(ids), torch.from_numpy(mask), ablation_mode=ablation_mode)
    assert out.dtype == torch.float32 and out.shape == (2, 7)
    assert model.input_dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_convert_mamba_vision_reads_the_baseline_tower():
    """JAX's convert_baseline_full reads a ResNet trunk only: the tower under
    ``image_encoder.model.`` is what ``convert_mamba_vision`` reads, bit for bit."""
    _, var, model = baseline_pair()
    prefix = "image_encoder.model."
    sd = {k[len(prefix):]: v.numpy() for k, v in model.state_dict().items() if k.startswith(prefix)}
    params, stats = convert_mamba_vision(sd, variant="TINY")
    want_p, want_s = var["params"]["image_encoder"]["trunk"], var["batch_stats"]["image_encoder"]["trunk"]
    for got, want in ((params, want_p), (stats, want_s)):
        g, w = dict(jax.tree_util.tree_leaves_with_path(got)), dict(jax.tree_util.tree_leaves_with_path(want))
        assert set(g) == set(w) and all(np.array_equal(g[k], w[k]) for k in w)
    assert not any(k.startswith((prefix + "norm.", prefix + "head.")) for k in model.state_dict())


def _flat_cos(a, b):
    a = np.concatenate([np.ravel(x) for x in a]).astype(np.float64)
    b = np.concatenate([np.ravel(x) for x in b]).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def test_a_training_step_matches_jax_grad():
    """Cross-entropy of a training-mode forward (BatchNorm on batch statistics,
    dropout 0): the loss rtol 1e-5, each tower's gradient cosine >= 0.9999 and its
    norm within 1e-3, the tower's new running statistics atol 1e-5."""
    jmodel, var, _ = baseline_pair()
    model = tbase.MultimodalBaselineModel(_cfg(tbase)).train()
    model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], None, "basic", "mlp"),
                          strict=False)
    img, (ids, mask) = _images(6, n=3), _text(7, n=3)
    labels = np.array([1, 4, 6])

    def jloss(params):
        logits, new = jmodel.apply({"params": params, "batch_stats": var["batch_stats"]}, jnp.asarray(img),
                                   jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32), train=True,
                                   mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1).mean(), new

    (jl, jnew), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(var["params"])
    logits = model(_nchw(img), torch.from_numpy(ids), torch.from_numpy(mask))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = baseline_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg), var["batch_stats"], None, "basic",
                                        "mlp")
    grads = {n: p.grad for n, p in model.named_parameters()}
    for tower in ("image_encoder", "text_encoder", "fusion", "classifier"):
        names = [n for n in grads if n.split(".")[0] == tower]
        assert all(grads[n] is not None for n in names), tower
        a, b = [grads[n].numpy() for n in names], [want[n].numpy() for n in names]
        assert _flat_cos(a, b) >= 0.9999, tower
        na, nb = (np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in v)) for v in (a, b))
        assert abs(na - nb) <= 1e-3 * nb, tower
    stats = baseline_state_dict_from_jax(var["params"], jax.tree_util.tree_map(np.asarray, jnew["batch_stats"]),
                                         None, "basic", "mlp")
    for k, v in model.state_dict().items():
        if k.startswith("image_encoder.") and (k.endswith("running_mean") or k.endswith("running_var")):
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


# --- the configuration ------------------------------------------------------------------------------
def test_the_json_config_is_the_yaml_resolution():
    cfg = load_config(REPO / "configs" / "ham" / "ham_mamba_vision_v1.yml")
    got = tconfig.load_config(REPO / "mdhs_tpu_torch" / "configs" / "ham_mamba_vision_v1.json")
    assert got.to_dict() == cfg.to_dict()
    spec = model_config(got, "baseline", 30522)
    want = jbase.BaselineConfig.from_config(cfg, bert=jbert.BertConfig())
    assert dataclasses.asdict(spec) == dataclasses.asdict(want)
    assert spec.image_backbone == "mamba_vision_T" and spec.fusion_type == "basic" and spec.classifier_type == "mlp"
