"""mdhs_tpu_torch models against the JAX package's, on the CPU in float32.

Weights come from the JAX ``init``, with every bias, LayerNorm/BatchNorm
affine and BatchNorm running statistic perturbed from its identity init
(as tests/test_full_model_parity.py perturbs its torch twin), and are
carried across by ``mibf_state_dict_from_jax``. Inputs are made with numpy
from a seed. The JAX side runs its module paths (no Pallas kernel lowers on
the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.core.convert import convert_mibf_full
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import mibf as jmibf
from mdhs_tpu.models import resnet as jresnet
from mdhs_tpu.modules import attention as jattn
from mdhs_tpu_torch.core.convert import (bert_state_dict_from_jax, joint_kv_state_dict_from_jax,
                                         mibf_state_dict_from_jax, resnet_state_dict_from_jax)
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import mibf as tmibf
from mdhs_tpu_torch.models import resnet as tresnet
from mdhs_tpu_torch.modules import attention as tattn

torch.set_num_threads(2)

# the sizes of tests/test_full_model_parity.py::test_mibf_full_model_logit_parity
MIBF_BERT = dict(vocab_size=128, hidden_size=768, num_hidden_layers=1, num_attention_heads=12,
                 intermediate_size=128, max_position_embeddings=64,
                 hidden_dropout=0.0, attention_dropout=0.0)
B, S, L, LABELS = 2, 64, 12, 6


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _perturb(params, stats, seed):
    """Move every bias/scale/running stat off its identity init, so a swap
    in the weight mapping shows in the outputs."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "bias":
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name == "scale":
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return a

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, stats))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, S, S, 3)).astype(np.float32)  # NHWC, the JAX layout
    ids = rng.integers(0, 128, (B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[1, 8:] = 0
    return img, ids, mask


def _nchw(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_mibf():
    model = jmibf.MIBFNet(num_labels=LABELS, bert=jbert.BertConfig(**MIBF_BERT), dtype=jnp.float32)
    img, ids, mask = _inputs()
    var = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(ids, jnp.int32),
                              jnp.asarray(mask, jnp.int32))
    params, stats = _perturb(_np_tree(var["params"]), _np_tree(var["batch_stats"]), seed=7)
    return model, params, stats


@pytest.fixture(scope="module")
def port_mibf(jax_mibf):
    _, params, stats = jax_mibf
    model = tmibf.MIBFNet(LABELS, tbert.BertConfig(**MIBF_BERT)).eval()
    model.load_state_dict(mibf_state_dict_from_jax(params, stats), strict=True)
    return model


def test_mibf_matches_jax(jax_mibf, port_mibf):
    model, params, stats = jax_mibf
    img, ids, mask = _inputs(1)
    ref = jax.jit(model.apply)({"params": params, "batch_stats": stats}, jnp.asarray(img),
                               jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        out = port_mibf(_nchw(img), torch.from_numpy(ids), torch.from_numpy(mask))
    for key in ("image_text", "text", "image"):
        assert out[key].dtype == torch.float32 and out[key].shape == (B, LABELS)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=2e-4, rtol=1e-3,
                                   err_msg=key)


def test_resnet_classifier_matches_jax(jax_mibf):
    _, params, stats = jax_mibf
    p, s = params["image_encoder"], stats["image_encoder"]
    img, _, _ = _inputs(2)
    jmodel = jresnet.ResNetClassifier("resnet50", 768, dtype=jnp.float32)
    ref, ref_taps = jax.jit(jmodel.apply)({"params": p, "batch_stats": s}, jnp.asarray(img))
    model = tresnet.ResNetClassifier("resnet50", 768).eval()
    model.load_state_dict(resnet_state_dict_from_jax(p, s), strict=True)
    with torch.no_grad():
        out, taps = model(_nchw(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    assert set(taps) == set(ref_taps) == {"stem", "layer1", "layer2", "layer3", "layer4"}
    for name, t in taps.items():
        assert t.permute(0, 2, 3, 1).shape == ref_taps[name].shape, name


def test_resnet18_taps_match_jax():
    img = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jmodel = jresnet.ResNet("resnet18", dtype=jnp.float32)
    var = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(img))
    p, s = _perturb(_np_tree(var["params"]), _np_tree(var["batch_stats"]), seed=9)
    ref = jax.jit(jmodel.apply)({"params": p, "batch_stats": s}, jnp.asarray(img))
    model = tresnet.ResNet("resnet18").eval()
    model.load_state_dict(resnet_state_dict_from_jax({"trunk": p}, {"trunk": s}), strict=True)
    with torch.no_grad():
        taps = model(_nchw(img))
    assert set(taps) == set(ref)
    for name, t in taps.items():
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(ref[name]),
                                   atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("heads", [1, 4])
def test_joint_kv_cross_attention_matches_jax(jax_mibf, heads):
    _, params, _ = jax_mibf
    p = params["textbased_cross_attention"]
    rng = np.random.default_rng(heads)
    x = rng.standard_normal((2, 3, 768)).astype(np.float32)
    y = rng.standard_normal((2, 5, 768)).astype(np.float32)
    jmod = jattn.JointKVCrossAttention(dim=768, num_heads=heads, dtype=jnp.float32)
    ref = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(y))
    mod = tattn.JointKVCrossAttention(768, heads)
    mod.load_state_dict(joint_kv_state_dict_from_jax(p), strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_convert_roundtrip_is_bit_exact(jax_mibf, port_mibf):
    _, params, stats = jax_mibf
    sd = {k: v.numpy() for k, v in port_mibf.state_dict().items()}
    back_p, back_s = convert_mibf_full(sd, num_bert_layers=MIBF_BERT["num_hidden_layers"])
    for want, got in ((params, back_p), (stats, back_s)):
        want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert {p for p, _ in want_leaves} == set(got_leaves)
        for path, a in want_leaves:
            b = got_leaves[path]
            assert b.dtype == a.dtype and b.shape == a.shape, path
            assert np.array_equal(a, b), path


def test_state_dict_keys_are_the_converters_keys(port_mibf):
    n_layers = MIBF_BERT["num_hidden_layers"]
    # BatchNorm's batch counter is torch's own, which no JAX tree holds
    sd = {k: v.numpy().copy() for k, v in port_mibf.state_dict().items()
          if not k.endswith(".num_batches_tracked")}
    params, stats = convert_mibf_full(sd, num_bert_layers=n_layers)
    # The converter hands each array on as it is or as a transposed view, so
    # every output leaf names the input array it came from: each key is read,
    # exactly once.
    leaves = jax.tree_util.tree_leaves((params, stats))
    sources = [id(a if a.base is None else a.base) for a in leaves]
    assert len(sources) == len(set(sources)) == len(sd)
    assert set(sources) == {id(v) for v in sd.values()}
    assert set(mibf_state_dict_from_jax(params, stats)) == set(sd)


@pytest.fixture(scope="module")
def bert_pair():
    cfg = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, max_position_embeddings=64, hidden_dropout=0.0,
               attention_dropout=0.0)
    jmodel = jbert.BertModel(jbert.BertConfig(**cfg), dtype=jnp.float32)
    ids, mask = _bert_inputs()
    var = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    params, _ = _perturb(_np_tree(var["params"]), {}, seed=3)
    model = tbert.BertModel(tbert.BertConfig(**cfg)).eval()
    model.load_state_dict(bert_state_dict_from_jax(params), strict=True)
    return jmodel, params, model


def _bert_inputs():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (3, 20)).astype(np.int64)
    mask = np.ones((3, 20), np.int64)
    mask[1, 13:] = 0
    mask[2, 4:] = 0
    return ids, mask


def test_bert_every_hidden_state_matches_jax(bert_pair):
    jmodel, params, model = bert_pair
    ids, mask = _bert_inputs()
    ref_last, ref_all = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        last, hidden = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(hidden) == len(ref_all) == 3
    for i, (h, r) in enumerate(zip(hidden, ref_all)):
        np.testing.assert_allclose(h.numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=f"hidden {i}")
    np.testing.assert_array_equal(last.numpy(), hidden[-1].numpy())


def test_bert_kernel_plumbing_matches_module_path(bert_pair):
    """The arguments BertLayer hands the sublayer kernels (packed Wqkv, the
    (B, L) bias, the FFN weights) are right: on CPU tensors the wrappers
    take their plain versions, which must agree with the module path."""
    _, _, model = bert_pair
    ids, mask = _bert_inputs()
    with torch.no_grad():
        _, hidden = model(torch.from_numpy(ids), torch.from_numpy(mask))
        bias = (1.0 - torch.from_numpy(mask)[:, None, None, :].float()) * -1e9
        for layer, h in zip(model.encoder.layer, hidden[:-1]):
            a_mod = layer.attention_sublayer(h, bias, kernel=False)
            a_ker = layer.attention_sublayer(h, bias, kernel=True)
            np.testing.assert_allclose(a_ker.numpy(), a_mod.numpy(), atol=1e-5, rtol=0)
            f_mod = layer.ffn_sublayer(a_mod, kernel=False)
            f_ker = layer.ffn_sublayer(a_mod, kernel=True)
            np.testing.assert_allclose(f_ker.numpy(), f_mod.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fast_math", [False, True])
def test_bert_plain_and_auto_agree_on_cpu(bert_pair, fast_math):
    # On the CPU "auto" takes the plain path; fast_math switches both to tanh-GELU.
    _, params, _ = bert_pair
    ids, mask = _bert_inputs()
    outs = []
    for impl in ("xla", "auto"):
        cfg = dataclasses.replace(bert_pair[2].cfg, attention_impl=impl, fast_math=fast_math)
        m = tbert.BertModel(cfg).eval()
        m.load_state_dict(bert_state_dict_from_jax(params), strict=True)
        with torch.no_grad():
            outs.append(m(torch.from_numpy(ids), torch.from_numpy(mask))[0])
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


@pytest.mark.parametrize("field, value, exc", [
    ("quantize", "int4", ValueError),
    ("sp_mesh_shape", (("data", 1), ("model", 2)), NotImplementedError),
    ("remat", "full", NotImplementedError),
    ("attention_impl", "sdpa", ValueError),
    ("attention_impl", "plain", ValueError),  # the module path goes by its JAX name, "xla"
])
def test_bert_unported_options_raise(field, value, exc):
    with pytest.raises(exc):
        tbert.BertModel(dataclasses.replace(tbert.BertConfig.tiny(), **{field: value}))


def test_bert_config_mirrors_the_jax_fields():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(tbert.BertConfig) == fields(jbert.BertConfig)
    assert tbert.BertConfig.tiny() == tbert.BertConfig(**dataclasses.asdict(jbert.BertConfig.tiny()))
