"""The ConNexT family of mdhs_tpu_torch against the JAX package's, on the CPU
in float32: the ConvNeXt tower, ``ConvCrossAttention2D``, the MoE at top-2
and ``ConNexTClassifier`` with both heads, its converter, its serving preset
and its serving runtime.

Weights come from the JAX ``init`` with every bias, LayerNorm affine, KAN
spline scaler and ConvNeXt layer scale moved off its init value (the layer
scale's 1e-6 would hide every block) and ``w_gate`` drawn (so rows route to
different experts), and are carried across by the port's converters.
Sizes: a registered pico ConvNeXt (depths (2, 2, 2, 2), dims (16, 24, 32,
40), as tests/test_full_model_parity.py builds it), a two-layer BERT 48
wide with 4 heads, KAN experts (48, 24, 16, 7). On the CPU the JAX MoE bank
runs ``kan_forward_ref``, its own plain version, as the JAX package's tests
run it there. Outputs within atol 2e-4 and rtol 1e-3, the tolerance of
tests/test_full_model_parity.py's ConNexT test and of the baseline port's.
The image tower also runs at 72 x 88, which no stride divides past the
second stage, for flax's asymmetric 'SAME' padding.
"""

import dataclasses
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.core.config import load_config
from mdhs_tpu.core.convert import convert_connext_full
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import connext as jconnext
from mdhs_tpu.models import convnext as jconvnext
from mdhs_tpu.modules import attention as jattn
from mdhs_tpu.modules import moe as jmoe
from mdhs_tpu.train.trainer import build_model
from mdhs_tpu_torch.core.convert import (_conv, connext_state_dict_from_jax, convnext_state_dict_from_jax,
                                         moe_state_dict_from_jax)
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import connext as tconnext
from mdhs_tpu_torch.models import convnext as tconvnext
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.modules import attention as tattn
from mdhs_tpu_torch.modules import moe as tmoe
from mdhs_tpu_torch.ops.preprocess import eval_pipeline
from mdhs_tpu_torch.presets import (CONNEXT_BALANCE_WEIGHT, CONNEXT_BATCH, CONNEXT_CANVAS, CONNEXT_CROP, CONNEXT_HAM,
                                    CONNEXT_SEQ)
from mdhs_tpu_torch.serving import ServingModel

torch.set_num_threads(2)
T = torch.from_numpy
REPO = Path(__file__).resolve().parent.parent
ATOL, RTOL = 2e-4, 1e-3
D = 48
DEPTHS, DIMS = (2, 2, 2, 2), (16, 24, 32, 40)
EXPERTS = (D, 24, 16, 7)
BERT = dict(vocab_size=120, hidden_size=D, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
B, L = 3, 12
for _module in (jconvnext, tconvnext):
    _module.register_convnext_variant("port_pico", DEPTHS, DIMS)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name == "bias":
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name in ("scale", "spline_scaler"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        if name == "gamma":  # the layer scale, 1e-6 at init
            return rng.uniform(0.3, 1.0, a.shape).astype(np.float32)
        if name == "w_gate":
            return rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _images(seed, n=B, h=64, w=64):
    return np.random.default_rng(seed).normal(size=(n, h, w, 3)).astype(np.float32)  # NHWC, the JAX layout


def _nchw(img):
    return T(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


def _close(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == np.shape(ref) and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------------- the ConvNeXt tower
@pytest.fixture(scope="module")
def tower():
    jmod = jconvnext.ConvNeXt(variant="port_pico", dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(_images(0)))["params"], seed=1)
    mod = tconvnext.ConvNeXt("port_pico").eval()
    mod.load_state_dict(convnext_state_dict_from_jax(params), strict=True)
    return jmod, params, mod


@pytest.mark.parametrize("h, w", [(64, 64), (72, 88)])
def test_convnext_tower_matches_jax(tower, h, w):
    jmod, params, mod = tower
    img = _images(2, h=h, w=w)
    ref = jmod.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        out = mod(_nchw(img))
    assert out.shape == ref.shape == (B, -(-h // 32), -(-w // 32), DIMS[-1])  # NHWC, as the JAX map
    _close(out, ref)


def test_convnext_blocks_carry_the_signal(tower):
    """The perturbed layer scales make each block count: zeroing them moves the map."""
    _, _, mod = tower
    x = _nchw(_images(3))
    with torch.no_grad():
        out = mod(x)
        saved = [layer.layer_scale_parameter.clone() for st in mod.encoder.stages for layer in st.layers]
        for st in mod.encoder.stages:
            for layer in st.layers:
                layer.layer_scale_parameter.zero_()
        bare = mod(x)
        for p, s in zip((layer.layer_scale_parameter for st in mod.encoder.stages for layer in st.layers), saved):
            p.copy_(s)
    assert (out - bare).abs().max() > 0.1 * out.abs().max()


def test_convnext_names_are_hf_convnextmodel():
    names = set(tconvnext.ConvNeXt("port_pico").state_dict())
    assert {"embeddings.patch_embeddings.weight", "embeddings.layernorm.bias",
            "encoder.stages.1.downsampling_layer.0.weight", "encoder.stages.1.downsampling_layer.1.bias",
            "encoder.stages.3.layers.1.layer_scale_parameter", "encoder.stages.0.layers.0.dwconv.weight",
            "encoder.stages.0.layers.0.pwconv2.bias"} <= names
    assert not any(n.startswith("encoder.stages.0.downsampling_layer") for n in names)
    assert len(names) == 4 + 3 * 4 + sum(DEPTHS) * 9


def test_convnext_encoder_matches_jax():
    jmod = jconvnext.create_convnext_encoder(output_dim=8, model_variant="convnext_port_pico", dtype=jnp.float32)
    img = _images(4)
    params = _perturb(jmod.init(jax.random.PRNGKey(5), jnp.asarray(img))["params"], seed=6)
    ref = jmod.apply({"params": params}, jnp.asarray(img))
    mod = tconvnext.create_convnext_encoder(8, "convnext_port_pico").eval()
    sd = convnext_state_dict_from_jax(params["backbone"], "backbone.")
    sd["projection.weight"], sd["projection.bias"] = (T(np.asarray(params["projection"]["kernel"]).T.copy()),
                                                      T(np.asarray(params["projection"]["bias"])))
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        _close(mod(_nchw(img)), ref)
    with pytest.raises(ValueError, match="unknown ConvNeXt variant"):
        tconvnext.create_convnext_encoder(8, "convnext_huge")


# --------------------------------------------------------------------------- the cross-attention and the MoE
@pytest.mark.parametrize("x_hw, y_hw", [((7, 7), (1, 1)), ((1, 1), (7, 7)), ((3, 5), (2, 4))])
def test_conv_cross_attention_matches_jax(x_hw, y_hw):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, *x_hw, D)).astype(np.float32)
    y = rng.standard_normal((2, *y_hw, D)).astype(np.float32)
    jmod = jattn.ConvCrossAttention2D(D, dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(8), x, y)["params"], seed=9)
    params = jax.tree_util.tree_map(lambda a: a * 0.3, params)  # unscaled scores: keep the softmax off saturation
    ref = jmod.apply({"params": params}, x, y)
    mod = tattn.ConvCrossAttention2D(D)
    sd = {}
    for name in ("query_conv", "key_conv", "value_conv"):
        _conv(params[name], name, sd)
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(T(x), T(y))
    assert out.shape == x.shape
    _close(out, ref)


def test_moe_top2_matches_jax():
    """ConNexT's head: MoE(input D, 7 labels, 4 experts, k=2) on a (D, 24, 16, 7) bank."""
    x = (np.random.default_rng(10).standard_normal((8, D)) * 0.8).astype(np.float32)
    jmod = jmoe.MoE(input_size=D, output_size=7, num_experts=4, k=2, expert_layers=EXPERTS, dtype=jnp.float32)
    var = jmod.init(jax.random.PRNGKey(11), jnp.asarray(x))
    params, state = _perturb(var["params"], 12), var["kan_state"]
    ref, ref_balance = jmod.apply({"params": params, "kan_state": state}, jnp.asarray(x))
    mod = tmoe.MoE(D, 7, 4, 2, expert_layers=EXPERTS)
    mod.load_state_dict(moe_state_dict_from_jax(params, state), strict=True)
    with torch.no_grad():
        out, balance = mod(T(x))
        gates, _ = tmoe.noisy_top_k_gating(T(x), mod.w_gate, mod.w_noise, 2)
    assert len(set(np.flatnonzero((gates > 0).any(0).numpy()))) == 4  # every expert chosen by some row
    _close(out, ref)
    np.testing.assert_allclose(balance.numpy(), np.asarray(ref_balance), rtol=1e-5)


# --------------------------------------------------------------------------- the whole model
def _cfg(module, head):
    return dict(num_labels=7, convnext_variant="port_pico", fusion_dim=D, head=head, moe_num_experts=4, moe_k=2,
                moe_expert_layers=EXPERTS, bert=module.BertConfig(**BERT))


def _text(seed, n=B):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 120, (n, L)).astype(np.int64)
    mask = np.ones((n, L), np.int64)
    mask[1, 8:] = 0  # a padded row
    return ids, mask


@functools.lru_cache(maxsize=None)
def pair(head):
    """(JAX model, its variables, the port's model with the same weights)."""
    jmodel = jconnext.ConNexTClassifier(**_cfg(jbert, head), dtype=jnp.float32)
    ids, mask = _text(0)
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(13), jnp.asarray(_images(0)), jnp.asarray(ids, jnp.int32),
                               jnp.asarray(mask, jnp.int32))
    var = {k: _perturb(v, seed=14 + i) for i, (k, v) in enumerate(var.items())}
    # the unscaled cross-attention softmax: keep the image-side scores of order 10, off saturation
    var["params"]["imagbased_cross_attention"] = jax.tree_util.tree_map(
        lambda a: a * 0.3, var["params"]["imagbased_cross_attention"])
    model = tconnext.ConNexTClassifier(tconnext.ConNexTConfig(**_cfg(tbert, head))).eval()
    model.load_state_dict(connext_state_dict_from_jax(var["params"], var.get("kan_state")), strict=True)
    return jmodel, var, model


@pytest.mark.parametrize("head", ["linear", "moe"])
def test_connext_matches_jax(head):
    jmodel, var, model = pair(head)
    img, (ids, mask) = _images(16), _text(17)
    ref, ref_balance = jax.jit(jmodel.apply)(var, jnp.asarray(img), jnp.asarray(ids, jnp.int32),
                                             jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        out, balance = model(_nchw(img), T(ids), T(mask))
    assert out.dtype == torch.float32 and out.shape == (B, 7) and balance.shape == ()
    _close(out, ref)
    np.testing.assert_allclose(balance.numpy(), np.asarray(ref_balance), rtol=1e-5, atol=1e-7)
    if head == "linear":
        assert float(balance) == 0.0


@pytest.mark.parametrize("head", ["linear", "moe"])
def test_connext_towers_and_fusion_match_jax(head):
    """The stages the card check holds apart: BERT's CLS, the ConvNeXt map, the fused feature."""
    jmodel, var, model = pair(head)
    img, (ids, mask) = _images(18), _text(19)

    def jax_parts(m, images, input_ids, attention_mask):
        text_last, _ = m.text_encoder(input_ids, attention_mask, deterministic=True)
        fmap = m.image_encoder(images)
        reduced = m.reduce_conv(fmap)
        text_map = text_last[:, 0, None, None, :]
        fused = (m.textbased_cross_attention(reduced, text_map).mean(axis=(1, 2))
                 + m.imagbased_cross_attention(text_map, reduced).mean(axis=(1, 2)))
        return text_last[:, 0], fmap, fused

    ref = jmodel.apply(var, jnp.asarray(img), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
                       method=jax_parts)
    with torch.no_grad():
        cls, fmap = model.towers(_nchw(img), T(ids), T(mask))
        fused = model.fuse(cls, fmap)
    for out, want in zip((cls, fmap, fused), ref):
        _close(out, want)


@pytest.mark.parametrize("head", ["linear", "moe"])
def test_connext_convert_roundtrip_is_bit_exact(head):
    """connext_state_dict_from_jax, then convert_connext_full: every leaf back bit for bit."""
    _, var, model = pair(head)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, kan_state = convert_connext_full(sd, head=head, convnext_variant="port_pico",
                                                    num_bert_layers=BERT["num_hidden_layers"], moe_num_experts=4)
    assert stats == {}
    pairs = [(var["params"], params)] + ([(var["kan_state"], kan_state)] if head == "moe" else [])
    for want, got in pairs:
        want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert {p for p, _ in want_leaves} == set(got_leaves)
        for path, a in want_leaves:
            b = got_leaves[path]
            assert b.dtype == a.dtype and b.shape == a.shape and np.array_equal(a, b), path
    # and the port's state_dict holds nothing else
    assert set(connext_state_dict_from_jax(params, kan_state or None)) == set(sd)


# --------------------------------------------------------------------------- preset, init, serving, refusals
def test_connext_ham_preset_is_the_yaml_resolution():
    cfg = load_config(REPO / "configs" / "connext" / "connext_ham.yml")
    want = build_model(cfg, "connext", SimpleNamespace(vocab_size=30522), dtype=jnp.float32)
    for f in dataclasses.fields(tconnext.ConNexTConfig):
        if f.name == "bert":
            assert dataclasses.asdict(CONNEXT_HAM.bert) == dataclasses.asdict(want.bert)
        else:
            assert getattr(CONNEXT_HAM, f.name) == getattr(want, f.name), f.name
    assert CONNEXT_HAM.head == "moe" and CONNEXT_HAM.convnext_variant == "base" and CONNEXT_HAM.moe_k == 2
    assert CONNEXT_BATCH == cfg.get("training.batch_size") == 32
    assert CONNEXT_SEQ == cfg.get("tokenizer.max_length") == 512
    assert (CONNEXT_CANVAS, CONNEXT_CROP) == (cfg.get("data.canvas"), cfg.get("data.image_size")) == (256, 224)
    assert CONNEXT_BALANCE_WEIGHT == cfg.get("model.moe.balance_weight") == 0.01


def test_connext_config_mirrors_the_jax_fields():
    jfields = {f.name: f.default for f in dataclasses.fields(jconnext.ConNexTClassifier)}
    for f in dataclasses.fields(tconnext.ConNexTConfig):
        default = f.default_factory() if f.default is dataclasses.MISSING else f.default
        if f.name == "bert":
            assert dataclasses.asdict(default) == dataclasses.asdict(jfields["bert"])
        else:
            assert default == jfields[f.name], f.name


def test_connext_init_is_the_jax_init():
    """Layer scale 1e-6, LayerNorms the identity, convolutions and linears lecun-scaled, biases 0."""
    model = init_parameters(tconnext.ConNexTClassifier(tconnext.ConNexTConfig(**_cfg(tbert, "moe"))),
                            torch.Generator().manual_seed(0))
    enc = model.image_encoder
    for stage in enc.encoder.stages:
        for layer in stage.layers:
            assert torch.all(layer.layer_scale_parameter == 1e-6)
            assert torch.all(layer.layernorm.weight == 1) and torch.all(layer.layernorm.bias == 0)
            assert torch.all(layer.dwconv.bias == 0)
    dw = torch.cat([layer.dwconv.weight.flatten() for st in enc.encoder.stages for layer in st.layers])
    assert abs(dw.std().item() - 1 / 7) < 0.01  # fan-in 49 of a depthwise 7x7
    q = model.imagbased_cross_attention.query_conv.weight
    assert abs(q.std().item() - D ** -0.5) < 0.01 and torch.all(model.conv.bias == 0)
    assert torch.all(model.moe.w_gate == 0)


def test_connext_serves_on_the_cpu():
    """ServingModel over a ConNexT: the logits of the (logits, balance) pair,
    ImageNet-normalised, each request's rows alone."""
    model = pair("moe")[2]
    rng = np.random.default_rng(20)
    ids, mask = _text(21, n=2)
    req = dict(image=rng.integers(0, 256, (2, 72, 72, 3), dtype=np.uint8), input_ids=ids, attention_mask=mask)
    out = ServingModel(model, 4, "cpu", image_size=64).predict(req)
    assert out.shape == (2, 7) and out.dtype == np.float32
    with torch.no_grad():
        images = eval_pipeline(T(req["image"]), 64, normalize=True, dtype=torch.float32)
        want, _ = model(images, T(ids), T(mask))
    np.testing.assert_allclose(out, want.numpy(), atol=1e-5, rtol=1e-5)
    assert model.normalize_input and model.input_dtype == torch.float32


@pytest.mark.parametrize("field, value, match", [("use_mamba_fusion", True, None), ("remat", "full", "item 8")])
def test_unported_options_raise(field, value, match):
    """remat raises naming its item; the Mamba fusion, once refused, builds and gives
    finite float32 logits and a zero balance loss, with and without the hidden
    vectors (tests/test_torch_port_multimodal_mamba.py holds it against JAX)."""
    cfg = dataclasses.replace(tconnext.ConNexTConfig(**_cfg(tbert, "linear")), **{field: value})
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            tconnext.ConNexTClassifier(cfg)
        return
    model = init_parameters(tconnext.ConNexTClassifier(cfg), torch.Generator().manual_seed(21)).eval()
    img, (ids, mask) = _images(22), _text(23)
    hidden = torch.randn((B, cfg.llm_hidden_dim), generator=torch.Generator().manual_seed(24))
    with torch.no_grad():
        for first, last in ((None, None), (hidden, -hidden)):
            out, balance = model(_nchw(img), T(ids), T(mask), first_hidden=first, last_hidden=last)
            assert out.dtype == torch.float32 and out.shape == (B, 7) and bool(torch.isfinite(out).all())
            assert float(balance) == 0.0


def test_unknown_convnext_variant_raises():
    with pytest.raises(ValueError, match="unknown ConvNeXt variant"):
        tconvnext.ConvNeXt("huge")
