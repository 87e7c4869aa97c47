"""The baseline family's fusions of mdhs_tpu_torch against the JAX package's, on
the CPU in float32: ``basic``, ``concat``, ``weighted_concat``, ``hadamard``,
``bilinear``, ``hierarchical`` and ``vmamba``.

Sizes: BERT 48 wide (3 layers, so ``hierarchical`` taps hidden states 1, 2
and 3) against a fusion 32 wide, so that ``basic``'s cross-attention takes
keys and values of another width (the context-width ``MultiHeadAttention``);
4 heads; ResNet18 at 64^2 (4 layer-4 tokens, the ``vmamba`` scan's L); text
of 10 tokens with one row padded after 6. Weights come from the JAX ``init``
(each fusion's own module, and one model a tower kind for the rest) with
every bias, affine, BatchNorm statistic, ``A_log``, ``dt_bias`` and ``D``
moved off its init value, and the zero-initialised ``w_img``, ``w_txt`` and
``scale_weights`` drawn off zero; ``baseline_state_dict_from_jax`` carries
them across. Tolerances: a fusion module atol 2e-5; the whole model's logits
atol 2e-4, rtol 1e-3, as ``tests/test_full_model_parity.py`` holds the JAX
baseline to its torch twin; a step's gradients each tower's cosine >=
0.9999 and each fusion tensor within 1e-3 of its largest entry.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.core.config import load_config as jload_config
from mdhs_tpu.core.convert import convert_baseline_full
from mdhs_tpu.models import baseline as jbase
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.modules import attention as jattn
from mdhs_tpu.modules import fusion as jfusion
from mdhs_tpu.modules import mamba as jmamba
from mdhs_tpu_torch.core.config import load_config as tload_config
from mdhs_tpu_torch.core.convert import (_ln, baseline_state_dict_from_jax, fusion_state_dict_from_jax,
                                         mamba_state_dict_from_jax, mha_state_dict_from_jax)
from mdhs_tpu_torch.models import baseline as tbase
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.modules import attention as tattn
from mdhs_tpu_torch.modules import fusion as tfusion
from mdhs_tpu_torch.modules import mamba as tmamba
from mdhs_tpu_torch.train.trainer import _split_precision

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
BERT = dict(vocab_size=128, hidden_size=48, num_hidden_layers=3, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
TEXT, HIDDEN, HEADS, LAYERS = 48, 32, 4, (1, 2, 3)
B, S, L = 2, 64, 10
FUSIONS = ("basic", "concat", "weighted_concat", "hadamard", "bilinear", "hierarchical", "vmamba")
MAPPED = ("basic", "concat", "weighted_concat", "hadamard", "bilinear")  # the fusions convert_baseline_full maps
MULTI = ("hierarchical",)
# the model's fusion inputs at these sizes: layer2/3/4 tokens of ResNet18 at 64^2, 8^2, 4^2 and 2^2
TOKENS = {"layer2": 64, "layer3": 16, "layer4": 4}
CONFIGS = {"ham_fusion_crossattn_v1": "ham", "ham_tta_attention_basic_mlp_v1": "ham", "ham_fusion_weighted_v1": "ham",
           "ham_fusion_hadamard_v1": "ham", "ham_fusion_bilinear_v1": "ham", "ham_fusion_vmamba_v1": "ham",
           "spine_hierarchical_v1": "spine"}
T = torch.from_numpy


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("bias", "conv1d_bias", "dt_bias", "mean"):
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name in ("scale", "var", "D"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        if name == "A_log":
            return (a + rng.uniform(-0.3, 0.3, a.shape)).astype(np.float32)
        if name in ("w_img", "w_txt", "scale_weights"):
            return rng.normal(0.0, 1.0, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _fusion_inputs(fusion, seed):
    """(image tokens, text tokens, text mask, BERT's hidden states) as the model hands them over."""
    rng = np.random.default_rng(seed)
    if fusion in MULTI:
        img = {k: rng.standard_normal((B, n, HIDDEN)).astype(np.float32) for k, n in TOKENS.items()}
    else:
        img = rng.standard_normal((B, TOKENS["layer4"], HIDDEN)).astype(np.float32)
    hidden = tuple(rng.standard_normal((B, L, TEXT)).astype(np.float32) for _ in range(LAYERS[-1] + 1))
    mask = np.ones((B, L), np.int32)
    mask[0, 6:] = 0
    return img, hidden[-1], mask, hidden


def _jfusion(fusion):
    return jfusion.build_fusion(fusion, text_dim=TEXT, hidden_dim=HIDDEN, num_heads=HEADS, dropout=0.0,
                                text_layers=LAYERS, dtype=jnp.float32, name=None)


def _jfusion_apply(fusion, params, img, txt, mask, hidden):
    kw = {"text_hidden_states": hidden} if fusion == "hierarchical" else {}
    return _jfusion(fusion).apply({"params": params}, img, txt, mask, **kw)


@functools.lru_cache(maxsize=None)
def fusion_params(fusion):
    """The JAX fusion's params, perturbed: the same tree the whole model holds under "fusion"."""
    img, txt, mask, hidden = _fusion_inputs(fusion, 0)
    kw = {"text_hidden_states": hidden} if fusion == "hierarchical" else {}
    params = _jfusion(fusion).init(jax.random.PRNGKey(1), img, txt, mask, **kw)["params"]
    return _perturb(jax.tree_util.tree_map(np.asarray, params), seed=2)


def _to_torch(x):
    if isinstance(x, dict):
        return {k: T(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(T(v) for v in x)
    return T(x)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_fusion_module_matches_jax(fusion):
    params = fusion_params(fusion)
    img, txt, mask, hidden = _fusion_inputs(fusion, 3)
    ref = _jfusion_apply(fusion, params, img, txt, mask, hidden)
    mod = tfusion.build_fusion(fusion, text_dim=TEXT, hidden_dim=HIDDEN, num_heads=HEADS, text_layers=LAYERS)
    mod.load_state_dict(fusion_state_dict_from_jax(params, fusion, prefix=""), strict=True)
    kw = {"text_hidden_states": _to_torch(hidden)} if fusion == "hierarchical" else {}
    with torch.no_grad():
        out = mod(_to_torch(img), T(txt), T(mask), **kw)
    assert out.shape == (B, HIDDEN)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_context_width_attention_matches_jax_under_nn_multihead_attention_names():
    """Queries 32 wide, keys and values 48: q/k/v_proj_weight as nn.MultiheadAttention(kdim, vdim) names them."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 7, HIDDEN)).astype(np.float32)
    kv = rng.standard_normal((2, 5, TEXT)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    jmod = jattn.MultiHeadAttention(HIDDEN, HEADS, dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(6), q, kv, kv)["params"], seed=7)
    ref = jmod.apply({"params": params}, q, kv, kv, key_padding_mask=mask)
    mod = tattn.MultiHeadAttention(HIDDEN, HEADS, kdim=TEXT, vdim=TEXT)
    sd = mha_state_dict_from_jax(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "q_proj_weight": (HIDDEN, HIDDEN), "k_proj_weight": (HIDDEN, TEXT), "v_proj_weight": (HIDDEN, TEXT),
        "in_proj_bias": (3 * HIDDEN,), "out_proj.weight": (HIDDEN, HIDDEN), "out_proj.bias": (HIDDEN,)}
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(T(q), T(kv), T(kv), T(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_vmamba_block_on_the_plain_scan_matches_selective_scan_ref():
    """The port's block on the CPU (the plain sequential scan, twice, one reversed) against
    the JAX block on the CPU (``selective_scan_ref``, the associative scan)."""
    u = np.random.default_rng(8).standard_normal((3, 11, 32)).astype(np.float32)
    jmod = jmamba.VMambaBlock(dim=32, num_heads=2, dtype=jnp.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(9), jnp.asarray(u))["params"], seed=10)
    ref = jmod.apply({"params": params}, jnp.asarray(u))
    mod = tmamba.VMambaBlock(32, num_heads=2)
    sd = {**mamba_state_dict_from_jax(params["fwd"], "fwd."), **mamba_state_dict_from_jax(params["bwd"], "bwd.")}
    _ln(params["norm"], "norm", sd)
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(T(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


# --- the whole model -------------------------------------------------------------------------
def _cfg(module, fusion):
    return module.BaselineConfig(num_classes=7, hidden_dim=HIDDEN, text_feature_dim=TEXT, num_heads=HEADS,
                                 dropout=0.0, fusion_type=fusion, classifier_type="mlp",
                                 bert=(jbert if module is jbase else tbert).BertConfig(**BERT))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)  # NHWC, the JAX layout
    ids = rng.integers(0, 128, (B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[0, 6:] = 0
    return img, ids, mask


def _jax_args(img, ids, mask):
    return jnp.asarray(img), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)


def _torch_args(img, ids, mask):
    return T(np.ascontiguousarray(img.transpose(0, 3, 1, 2))), T(ids), T(mask)


@functools.lru_cache(maxsize=None)
def towers(multi_scale):
    """The perturbed variables of a model of the tower kind, its fusion left out."""
    jmodel = jbase.MultimodalBaselineModel(_cfg(jbase, "multiscale" if multi_scale else "concat"), dtype=jnp.float32)
    var = jmodel.init(jax.random.PRNGKey(0), *_jax_args(*_inputs(0)))
    var = {k: _perturb(jax.tree_util.tree_map(np.asarray, v), seed=i) for i, (k, v) in enumerate(var.items())}
    var["params"] = {k: v for k, v in var["params"].items() if k != "fusion"}
    return var


@functools.lru_cache(maxsize=None)
def pair(fusion):
    """(JAX model, its variables, the port's model with the same weights)."""
    jmodel = jbase.MultimodalBaselineModel(_cfg(jbase, fusion), dtype=jnp.float32)
    var = towers(fusion in MULTI)
    var = {**var, "params": {**var["params"], "fusion": fusion_params(fusion)}}
    model = tbase.MultimodalBaselineModel(_cfg(tbase, fusion)).eval()
    model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], None, fusion, "mlp"),
                          strict=True)
    return jmodel, var, model


MODES = (None, "image_only", "text_off")


@functools.lru_cache(maxsize=None)
def jax_logits(fusion):
    """The JAX model's logits on ``_inputs(1)`` under every ablation mode, one compile."""
    jmodel, var, _ = pair(fusion)
    fn = jax.jit(lambda v, *a: [jmodel.apply(v, *a, ablation_mode=m) for m in MODES])
    return dict(zip(MODES, map(np.asarray, fn(var, *_jax_args(*_inputs(1))))))


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("ablation_mode", MODES)
def test_baseline_with_each_fusion_matches_jax(fusion, ablation_mode):
    _, _, model = pair(fusion)
    with torch.no_grad():
        out = model(*_torch_args(*_inputs(1)), ablation_mode=ablation_mode)
    assert out.dtype == torch.float32 and out.shape == (B, 7)
    np.testing.assert_allclose(out.numpy(), jax_logits(fusion)[ablation_mode], atol=2e-4, rtol=1e-3)


def _cos(a, b):
    a, b = (np.concatenate([np.asarray(t, np.float64).ravel() for t in x]) for x in (a, b))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("fusion", ["basic", "vmamba"])
def test_a_training_step_s_gradients_match_jax_grad(fusion):
    """The cross-entropy of a train-mode forward (BatchNorm on the batch's statistics,
    dropout 0): every parameter's gradient against ``jax.grad``; for vmamba both scans'
    gradients come back through the associative scan's VJP, the reversed one through the flip."""
    jmodel, var, model = pair(fusion)
    img, ids, mask = _inputs(4)
    labels = np.array([3, 5])

    def loss_fn(params):
        logits, _ = jmodel.apply({**var, "params": params}, *_jax_args(img, ids, mask), train=True,
                                 mutable=["batch_stats"])
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[:, None], 1))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(var["params"])
    jg = baseline_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), var["batch_stats"], None, fusion)
    model.train()
    try:
        model.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(*_torch_args(img, ids, mask)), T(labels))
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
    finally:
        model.eval().zero_grad(set_to_none=True)
        model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], None, fusion, "mlp"))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert all(g is not None for g in grads.values())
    for tower in ("image_encoder", "text_encoder", "fusion", "classifier"):
        names = [n for n in grads if n.startswith(tower + ".")]
        c = _cos([grads[n].numpy() for n in names], [jg[n].numpy() for n in names])
        assert c >= 0.9999, (tower, c)
    for n in (n for n in grads if n.startswith("fusion.")):
        ref = jg[n].numpy()
        assert np.abs(grads[n].numpy() - ref).max() <= 1e-3 * np.abs(ref).max(), n


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("fusion", FUSIONS)
def test_baseline_state_dict_from_jax_is_bit_exact(fusion):
    """Every JAX leaf lands in the port's state dict bit for bit, and the dict holds nothing
    else; for the fusions convert_baseline_full maps, it reads the port's state_dict() back
    into the same tree."""
    _, var, model = pair(fusion)
    sd = {k: v.numpy() for k, v in model.state_dict().items() if not k.endswith(".num_batches_tracked")}
    carried = baseline_state_dict_from_jax(var["params"], var["batch_stats"], None, fusion)
    assert set(carried) == set(sd)
    assert all(np.array_equal(carried[k].numpy(), sd[k]) and carried[k].dtype == torch.float32 for k in sd)
    n_jax = sum(a.size for tree in (var["params"], var["batch_stats"]) for a in _leaves(tree).values())
    assert n_jax == sum(a.size for a in sd.values())
    if fusion not in MAPPED:
        return
    params, stats = convert_baseline_full(sd, fusion, "mlp", "resnet18", BERT["num_hidden_layers"])
    for want, got in ((var["params"], params), (var["batch_stats"], stats)):
        want, got = _leaves(want), _leaves(got)
        assert set(want) == set(got)
        for path, a in want.items():
            assert got[path].dtype == a.dtype and np.array_equal(a, got[path]), path


@pytest.mark.parametrize("fusion", FUSIONS)
def test_the_fusion_s_state_dict_names(fusion):
    _, _, model = pair(fusion)
    names = {k[len("fusion."):] for k in model.state_dict() if k.startswith("fusion.")}
    mha = ("in_proj_weight", "in_proj_bias", "out_proj.weight", "out_proj.bias")
    lin = ("weight", "bias")
    mamba = ("in_proj.weight", "conv1d.weight", "conv1d.bias", "x_proj.weight", "dt_proj.weight", "dt_bias",
             "A_log", "D", "out_proj.weight")
    cross = {f"cross_l{s}.{m}.{n}" for s in (2, 3, 4) for m, ns in (("txt_proj", lin), ("attn", mha), ("norm", lin))
             for n in ns}
    want = {
        "basic": {f"transformer_block.{m}.{n}" for m in ("norm1", "norm2", "norm3", "ff.0", "ff.3") for n in lin}
        | {f"transformer_block.attn1.{n}" for n in mha}
        | {f"transformer_block.attn2.{n}" for n in ("q_proj_weight", "k_proj_weight", "v_proj_weight", *mha[1:])},
        "concat": {f"proj.{n}" for n in lin},
        "weighted_concat": {f"proj.{n}" for n in lin} | {"w_img", "w_txt"},
        "hadamard": {f"{m}.{n}" for m in ("img_proj", "txt_proj", "norm") for n in lin},
        "bilinear": {f"{m}.{n}" for m in ("img_proj", "txt_proj", "out_proj", "norm") for n in lin},
        "hierarchical": cross | {"scale_weights"},
        "vmamba": {f"{m}.{n}" for m in ("txt_proj", "in_proj", "out_proj", "vmamba.norm") for n in lin}
        | {f"vmamba.{d}.{n}" for d in ("fwd", "bwd") for n in mamba},
    }[fusion]
    assert names == want
    if fusion == "bilinear":
        assert tuple(model.fusion.img_proj.weight.shape) == (tfusion.BILINEAR_RANK, HIDDEN) == (128, 32)
    if fusion == "vmamba":
        assert tuple(model.fusion.in_proj.weight.shape) == (32, HIDDEN) and model.fusion.vmamba.fwd.d_inner == 64


def test_hierarchical_taps_thirds_of_bert_and_refuses_a_layer_out_of_range():
    for layers, want in ((12, (4, 8, 12)), (3, (1, 2, 3)), (2, (1, 1, 2)), (1, (1, 1, 1))):
        cfg = dataclasses.replace(_cfg(tbase, "hierarchical"),
                                  bert=tbert.BertConfig(**{**BERT, "num_hidden_layers": layers}))
        assert tbase.MultimodalBaselineModel(cfg, device="meta").fusion.text_layers == want
    mod = tfusion.HierarchicalFusion(TEXT, HIDDEN, HEADS, text_layers=(1, 2, 5))
    img, txt, mask, hidden = _fusion_inputs("hierarchical", 3)
    with pytest.raises(ValueError, match="index 5 out of range for 4"):
        mod(_to_torch(img), T(txt), T(mask), text_hidden_states=_to_torch(hidden))


def test_single_scale_fusions_refuse_the_multiscale_dict():
    img, txt, mask, _ = _fusion_inputs("hierarchical", 3)
    mod = tfusion.build_fusion("vmamba", text_dim=TEXT, hidden_dim=HIDDEN)
    with pytest.raises(ValueError, match="single-scale"):
        mod(_to_torch(img), T(txt), T(mask))
    with pytest.raises(KeyError, match="unknown fusion_type"):
        tfusion.build_fusion("gated", text_dim=TEXT, hidden_dim=HIDDEN)


@pytest.mark.parametrize("fusion, names", [("weighted_concat", ("w_img", "w_txt")),
                                           ("hierarchical", ("scale_weights",)),
                                           ("vmamba", tuple(f"vmamba.{d}.{n}" for d in ("fwd", "bwd")
                                                            for n in ("dt_bias", "A_log", "D")))])
def test_float32_islands_of_the_fusions(fusion, names):
    """A bf16 model keeps the fusions' scalar weights and both VMamba blocks' dt_bias,
    A_log and D float32, and so does the trainer's precision split; init_parameters
    zeroes the scalar weights, as flax's init."""
    from mdhs_tpu_torch.models.init import init_parameters

    model = tbase.MultimodalBaselineModel(_cfg(tbase, fusion), dtype=torch.bfloat16)
    f32 = {n[len("fusion."):] for n, t in model.state_dict().items() if t.dtype == torch.float32}
    assert f32 == set(names)
    model = tbase.MultimodalBaselineModel(_cfg(tbase, fusion))
    with torch.no_grad():
        for p in model.fusion.parameters():
            p.fill_(0.5)
    init_parameters(model, torch.Generator().manual_seed(0))
    _split_precision(model, torch.bfloat16)
    kept = {n[len("fusion."):] for n, p in model.named_parameters() if n.startswith("fusion.")
            and p.dtype == torch.float32}
    assert kept == set(names)
    if fusion != "vmamba":
        assert all(float(getattr(model.fusion, n).abs().max()) == 0.0 for n in names)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_fusion_json_configs_are_their_yaml_resolved(name):
    assert tload_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json").to_dict() == \
        jload_config(REPO / "configs" / CONFIGS[name] / f"{name}.yml").to_dict()
