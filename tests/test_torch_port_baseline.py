"""MultimodalBaselineModel of mdhs_tpu_torch against the JAX package's, on the
CPU in float32: multiscale + mlp, mamba + mlp (the selective scan),
multiscale + moe (the KAN bank), and multiscale with base.yml's ``kan``
head, ``residual`` and ``attention_pooling``.

Weights come from the JAX ``init`` with every bias, LayerNorm/BatchNorm
affine and running statistic, ``A_log``, ``dt_bias``, ``D`` and KAN spline
scaler moved off its init value and ``w_gate`` drawn (so rows route to
different experts), and are carried across by
``baseline_state_dict_from_jax``. Sizes: ResNet18 at 64^2, a two-layer BERT
32 wide, hidden 32, 4 heads, d_state 16, KAN experts (32, 128, 7). Logits
within atol 2e-4, rtol 1e-3, as tests/test_full_model_parity.py holds the
JAX baseline to its torch twin.
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
from mdhs_tpu.core.convert import _convert_kan_bank, convert_baseline_full
from mdhs_tpu.models import baseline as jbase
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import encoders as jenc
from mdhs_tpu.modules import attention as jattn
from mdhs_tpu.train.trainer import bert_config_from
from mdhs_tpu_torch.core.convert import (_lin, baseline_state_dict_from_jax, mha_state_dict_from_jax,
                                         resnet_state_dict_from_jax)
from mdhs_tpu_torch.models import baseline as tbase
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import encoders as tenc
from mdhs_tpu_torch.modules import attention as tattn
from mdhs_tpu_torch.presets import BASELINE_BATCH, BASELINE_SEQ, HAM_FUSION_SSM, HAM_HEAD_MOE

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
B, S, L = 2, 64, 10
CONFIGS = [("multiscale", "mlp"), ("mamba", "mlp"), ("multiscale", "moe"), ("multiscale", "kan"),
           ("multiscale", "residual"), ("multiscale", "attention_pooling")]


def _cfg(module, fusion, head):
    return module.BaselineConfig(num_classes=7, hidden_dim=32, text_feature_dim=32, num_heads=4, dropout=0.0,
                                 fusion_type=fusion, classifier_type=head,
                                 bert=(jbert if module is jbase else tbert).BertConfig(**BERT))


def _inputs(seed, n=B):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, S, S, 3)).astype(np.float32)  # NHWC, the JAX layout
    ids = rng.integers(0, 128, (n, L)).astype(np.int64)
    mask = np.ones((n, L), np.int64)
    mask[0, 6:] = 0
    return img, ids, mask


def _jax_args(img, ids, mask):
    return jnp.asarray(img), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)


def _torch_args(img, ids, mask):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))), torch.from_numpy(ids), torch.from_numpy(mask)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("bias", "conv1d_bias", "dt_bias", "mean"):
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name in ("scale", "var", "D", "spline_scaler", "act_base"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        if name == "act_coeff":
            return (a + rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if name == "A_log":
            return (a + rng.uniform(-0.3, 0.3, a.shape)).astype(np.float32)
        if name == "w_gate":
            return rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def pair(fusion, head):
    """(JAX model, its variables, the port's model with the same weights)."""
    jmodel = jbase.MultimodalBaselineModel(_cfg(jbase, fusion, head), dtype=jnp.float32)
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *_jax_args(*_inputs(0)))
    var = {k: _perturb(var[k], seed=i) for i, k in enumerate(("params", "batch_stats", "kan_state")) if k in var}
    model = tbase.MultimodalBaselineModel(_cfg(tbase, fusion, head)).eval()
    model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], var.get("kan_state"),
                                                       fusion, head), strict=True)
    return jmodel, var, model


@pytest.mark.parametrize("fusion, head", CONFIGS)
@pytest.mark.parametrize("ablation_mode", [None, "image_only", "text_off"])
def test_baseline_matches_jax(fusion, head, ablation_mode):
    jmodel, var, model = pair(fusion, head)
    args = _inputs(1)
    ref = jax.jit(functools.partial(jmodel.apply, ablation_mode=ablation_mode))(var, *_jax_args(*args))
    with torch.no_grad():
        out = model(*_torch_args(*args), ablation_mode=ablation_mode)
    assert out.dtype == torch.float32 and out.shape == (B, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


def test_unknown_ablation_mode_raises():
    _, _, model = pair("multiscale", "mlp")
    with pytest.raises(ValueError, match="ablation_mode"):
        model(*_torch_args(*_inputs(1)), ablation_mode="image")


def test_convert_roundtrip_is_bit_exact():
    """multiscale + mlp, the pair convert_baseline_full maps: every leaf back bit for bit."""
    _, var, model = pair("multiscale", "mlp")
    sd = {k: v.numpy() for k, v in model.state_dict().items() if not k.endswith(".num_batches_tracked")}
    params, stats = convert_baseline_full(sd, "multiscale", "mlp", "resnet18", BERT["num_hidden_layers"])
    for want, got in ((var["params"], params), (var["batch_stats"], stats)):
        want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert {p for p, _ in want_leaves} == set(got_leaves)
        for path, a in want_leaves:
            b = got_leaves[path]
            assert b.dtype == a.dtype and b.shape == a.shape and np.array_equal(a, b), path
    # and the port's state_dict holds nothing else
    assert set(baseline_state_dict_from_jax(params, stats)) == set(sd)


def test_convert_roundtrip_of_the_residual_head_is_bit_exact():
    """multiscale + residual: the names convert_baseline_full's _convert_head reads
    (classifier.project, classifier.res_block.{linear1,linear2,norm},
    classifier.classifier) give every leaf back bit for bit."""
    _, var, model = pair("multiscale", "residual")
    sd = {k: v.numpy() for k, v in model.state_dict().items() if not k.endswith(".num_batches_tracked")}
    params, stats = convert_baseline_full(sd, "multiscale", "residual", "resnet18", BERT["num_hidden_layers"])
    for want, got in ((var["params"], params), (var["batch_stats"], stats)):
        want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert {p for p, _ in want_leaves} == set(got_leaves)
        for path, a in want_leaves:
            assert np.array_equal(a, got_leaves[path]), path
    assert set(baseline_state_dict_from_jax(params, stats, classifier_type="residual")) == set(sd)


def test_kan_bank_layout_is_the_converters():
    _, var, model = pair("multiscale", "moe")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, state = _convert_kan_bank(sd, "classifier.moe.experts.", 4)
    want_p = var["params"]["classifier"]["moe"]["experts"]
    want_s = var["kan_state"]["classifier"]["moe"]["experts"]
    for want, got in ((want_p, params), (want_s, state)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert {p for p, _ in flat_w} == set(flat_g)
        for path, a in flat_w:
            assert np.array_equal(a, flat_g[path]), path


def test_mamba_names_follow_mamba_ssm():
    _, _, model = pair("mamba", "mlp")
    names = {k[len("fusion."):] for k in model.state_dict() if k.startswith("fusion.")}
    assert names == {"txt_proj.weight", "txt_proj.bias"} | {
        f"mamba.{n}" for n in ("in_proj.weight", "conv1d.weight", "conv1d.bias", "x_proj.weight", "dt_proj.weight",
                               "dt_bias", "A_log", "D", "out_proj.weight")}


def test_image_tokens_match_jax():
    rng = np.random.default_rng(2)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmod = jenc.ImageTokenEncoder(feature_dim=16, multi_scale=True, dtype=jnp.float32)
    var = jmod.init(jax.random.PRNGKey(3), jnp.asarray(img))
    var = {k: _perturb(v, seed=4) for k, v in var.items()}
    ref, _ = jmod.apply(var, jnp.asarray(img))
    mod = tenc.ImageTokenEncoder(16, multi_scale=True).eval()
    sd = resnet_state_dict_from_jax({"trunk": var["params"]["trunk"]}, var["batch_stats"], "model.")
    for s in (2, 3, 4):
        _lin(var["params"][f"proj_layer{s}"], f"proj{s}", sd)
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out, _ = mod(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))))
    assert set(out) == set(ref) == {"layer2", "layer3", "layer4"}
    for k in out:
        assert out[k].shape == ref[k].shape  # (B, H*W, 16): 8^2, 4^2, 2^2 tokens
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-5, rtol=0, err_msg=k)


def test_multi_head_attention_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 7, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    jmod = jattn.MultiHeadAttention(32, 4, dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(6), q, kv, kv)["params"], seed=7)
    ref = jmod.apply({"params": params}, q, kv, kv, key_padding_mask=mask)
    mod = tattn.MultiHeadAttention(32, 4)
    mod.load_state_dict(mha_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("yml, preset", [("ham_fusion_ssm_v1.yml", HAM_FUSION_SSM),
                                          ("ham_head_moe_v1.yml", HAM_HEAD_MOE)])
def test_serving_presets_are_the_yaml_resolution(yml, preset):
    cfg = load_config(REPO / "configs" / "ham" / yml)
    want = jbase.BaselineConfig.from_config(cfg, bert=bert_config_from(cfg, vocab_size=30522))
    assert dataclasses.asdict(preset) == dataclasses.asdict(want)
    assert BASELINE_BATCH == cfg.get("training.batch_size") == 64
    assert BASELINE_SEQ == cfg.get("tokenizer.max_length") == 128


def test_baseline_config_mirrors_the_jax_fields():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls) if f.name != "bert"}

    assert fields(tbase.BaselineConfig) == fields(jbase.BaselineConfig)
    assert dataclasses.asdict(tbase.BaselineConfig()) == dataclasses.asdict(jbase.BaselineConfig())


@pytest.mark.parametrize("field, value, match", [
    ("remat", "selective", "item 8"), ("image_backbone", "mamba_vision_S", "item 11"), ("remat", "full", "item 8"),
    ("image_backbone", "mamba_vision_T", "item 11"),
])
def test_unported_options_raise(field, value, match):
    cfg = dataclasses.replace(_cfg(tbase, "multiscale", "mlp"), **{field: value})
    with pytest.raises(NotImplementedError, match=match):
        tbase.MultimodalBaselineModel(cfg)


@pytest.mark.parametrize("fusion", ["weighted_concat", "hadamard", "basic", "vmamba", "hierarchical", "concat",
                                    "bilinear"])
def test_every_fusion_builds_and_runs(fusion):
    """The fusions that once raised build and give finite logits in each ablation mode
    (tests/test_torch_port_fusion.py holds each against the JAX package)."""
    model = tbase.MultimodalBaselineModel(_cfg(tbase, fusion, "mlp")).eval()
    with torch.no_grad():
        for mode in tbase.ABLATION_MODES:
            out = model(*_torch_args(*_inputs(1)), ablation_mode=mode)
            assert out.shape == (B, 7) and bool(torch.isfinite(out).all()), mode


def test_float32_islands_in_a_bf16_model():
    """A bf16 baseline keeps the KAN layers, the grid, the MoE gate and
    Mamba's dt_bias, A_log and D in float32; its input dtype is bf16."""
    for fusion, head in (("mamba", "moe"),):
        model = tbase.MultimodalBaselineModel(_cfg(tbase, fusion, head), dtype=torch.bfloat16)
        f32 = {n for n, t in model.state_dict().items() if t.dtype == torch.float32}
        mamba = {f"fusion.mamba.{n}" for n in ("dt_bias", "A_log", "D")}
        moe = {"classifier.moe.w_gate", "classifier.moe.w_noise"} | {
            f"classifier.moe.experts.{e}.layers.{i}.{n}" for e in range(4) for i in range(2)
            for n in ("base_weight", "spline_weight", "spline_scaler", "grid")}
        assert f32 == mamba | moe
        assert model.input_dtype == torch.bfloat16 and model.normalize_input
