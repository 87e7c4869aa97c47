"""ConNexT's multimodal Mamba fusion of mdhs_tpu_torch against the JAX package's,
on the CPU in float32: ``KANMultiheadAttention`` with and without a mask,
``MultimodalMamba`` with and without KAN attention, ``SimpleFusion``, ConNexT
with ``use_mamba_fusion`` with and without the LLM hidden vectors, the
converter, the dataset's hidden-state mode (zero fill, pad, truncate), the
trainer's eval logits with TTA tiling against JAX's ``eval_step_fn``, and a
training step's gradients against ``jax.grad`` through the JAX Trainer's loss.

The JAX init's weights, every bias, LayerNorm affine, ``A_log``, ``dt_bias``,
``D`` and KAN spline scaler moved off its init, are carried across by
``connext_state_dict_from_jax``. Sizes: the registered pico ConvNeXt (a 2 x 2
map at 64^2: a sequence of 7), BERT 48 wide, the fusion's fixed width 256 and
d_state 128, hidden vectors 24 wide. Outputs within atol 2e-4, rtol 1e-3
(tests/test_torch_port_connext.py's float32 tolerance); gradients within a
cosine of 0.9999 a tower.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_connext as tc  # registers the pico ConvNeXt in both packages
from mdhs_tpu.core.config import Config as JConfig
from mdhs_tpu.data import datasets as jdata
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import connext as jconnext
from mdhs_tpu.modules import multimodal_mamba as jmm
from mdhs_tpu.train.trainer import Trainer as JTrainer
from mdhs_tpu_torch.cli import common as tcommon
from mdhs_tpu_torch.core.config import Config
from mdhs_tpu_torch.core.convert import (_lin, connext_state_dict_from_jax, kan_state_dict_from_jax,
                                         multimodal_mamba_state_dict_from_jax)
from mdhs_tpu_torch.data import datasets as tdata
from mdhs_tpu_torch.data import tokenizer as ttok
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import connext as tconnext
from mdhs_tpu_torch.modules import multimodal_mamba as tmm
from mdhs_tpu_torch.train.trainer import Trainer
from test_torch_port_train_cli import B, carry_weights, flat_cos, jax_batch, no_dropout, train_config, write_dataset

torch.set_num_threads(2)
T = torch.from_numpy
ATOL, RTOL = 2e-4, 1e-3
HIDDEN = 24


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("bias", "conv1d_bias", "dt_bias"):
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name in ("scale", "D", "spline_scaler"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        if name == "A_log":
            return (a + rng.uniform(-0.3, 0.3, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------- the modules
@pytest.mark.parametrize("masked", [False, True])
def test_kan_attention_matches_jax(masked):
    D, L = 32, 6
    x = _x(1, (3, L, D))
    mask = None
    if masked:  # keys 4.. hidden from row 0, key 0 from row 2
        m = np.ones((3, 1, 1, L), np.float32)
        m[0, ..., 4:] = 0
        m[2, ..., 0] = 0
        mask = m
    jm = jmm.KANMultiheadAttention(D, num_heads=4, dtype=jnp.float32)
    var = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    var = {k: _np(_perturb(v, 3)) for k, v in var.items()}
    ref = jax.jit(jm.apply)(var, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    mod = tmm.KANMultiheadAttention(D, num_heads=4).eval()
    want = {}
    for n in ("q_proj", "k_proj", "v_proj"):
        want.update(kan_state_dict_from_jax(var["params"][n], var["kan_state"][n], f"{n}."))
    _lin(var["params"]["out_proj"], "out_proj", want)
    mod.load_state_dict(want, strict=True)
    with torch.no_grad():
        out = mod(T(x), None if mask is None else T(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _fusion_inputs(seed, n=3, tokens=4, text=20, img=12):
    return _x(seed, (n, text)), _x(seed + 1, (n, tokens, img)), _x(seed + 2, (n, HIDDEN)), _x(seed + 3, (n, HIDDEN))


@pytest.mark.parametrize("kan_attention", [True, False])
def test_multimodal_mamba_matches_jax(kan_attention):
    args = _fusion_inputs(5)
    jm = jmm.MultimodalMamba(text_dim=20, img_dim=12, hidden_dim=HIDDEN, use_kan_attention=kan_attention,
                             dtype=jnp.float32)
    var = jax.jit(jm.init)(jax.random.PRNGKey(6), *map(jnp.asarray, args))
    var = {k: _np(_perturb(v, 7)) for k, v in var.items()}
    ref = jax.jit(jm.apply)(var, *map(jnp.asarray, args))
    mod = tmm.MultimodalMamba(text_dim=20, img_dim=12, hidden_dim=HIDDEN, use_kan_attention=kan_attention).eval()
    mod.load_state_dict(multimodal_mamba_state_dict_from_jax(var["params"], var.get("kan_state")), strict=True)
    with torch.no_grad():
        out = mod(*map(T, args))
    assert out.shape == (3, 4 + 3, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_simple_fusion_matches_jax():
    args = _fusion_inputs(8)
    jm = jmm.SimpleFusion(proj_dim=16, dtype=jnp.float32)
    var = _np(_perturb(jm.init(jax.random.PRNGKey(9), *map(jnp.asarray, args)), 10))
    ref = jm.apply(var, *map(jnp.asarray, args))
    mod = tmm.SimpleFusion(20, 12, HIDDEN, proj_dim=16)
    want = {}
    for n in ("text_proj", "img_proj", "hidden_proj"):
        _lin(var["params"][n], n, want)
    mod.load_state_dict(want, strict=True)
    with torch.no_grad():
        out = mod(*map(T, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------------- ConNexT with the fusion
def _cfg(module):
    return dict(num_labels=7, convnext_variant="port_pico", fusion_dim=tc.D, head="moe", moe_num_experts=4, moe_k=2,
                moe_expert_layers=tc.EXPERTS, use_mamba_fusion=True, llm_hidden_dim=HIDDEN,
                bert=module.BertConfig(**tc.BERT))


@pytest.fixture(scope="module")
def pair():
    jmodel = jconnext.ConNexTClassifier(**_cfg(jbert), dtype=jnp.float32)
    ids, mask = tc._text(0)
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(13), jnp.asarray(tc._images(0)), jnp.asarray(ids, jnp.int32),
                               jnp.asarray(mask, jnp.int32))
    var = {k: _np(_perturb(v, seed=14 + i)) for i, (k, v) in enumerate(var.items())}
    model = tconnext.ConNexTClassifier(tconnext.ConNexTConfig(**_cfg(tbert))).eval()
    model.load_state_dict(connext_state_dict_from_jax(var["params"], var.get("kan_state")), strict=True)
    return jmodel, var, model


def test_the_jax_tree_holds_only_what_the_fusion_forward_calls(pair):
    """Flax made no parameters for the cross-attention path or the head; the port
    builds none either, and its state_dict is the converter's, key for key."""
    _, var, model = pair
    assert set(var["params"]) == {"text_encoder", "image_encoder", "mamba_fusion", "mamba_fc"}
    assert set(var["kan_state"]) == {"mamba_fusion"} and set(var["kan_state"]["mamba_fusion"]["attn"]) == {
        "q_proj", "k_proj", "v_proj"}
    assert not any(hasattr(model, n) for n in ("conv", "textbased_cross_attention", "imagbased_cross_attention",
                                               "fc", "moe"))
    assert model.mamba_fusion.proj_img.in_features == tc.DIMS[-1]
    assert set(connext_state_dict_from_jax(var["params"], var["kan_state"])) == set(model.state_dict())


@pytest.mark.parametrize("hidden", [True, False])
def test_connext_with_the_mamba_fusion_matches_jax(pair, hidden):
    jmodel, var, model = pair
    img, (ids, mask) = tc._images(16), tc._text(17)
    fh, lh = (_x(18, (tc.B, HIDDEN)), _x(19, (tc.B, HIDDEN))) if hidden else (None, None)
    ref, ref_balance = jax.jit(jmodel.apply)(var, jnp.asarray(img), jnp.asarray(ids, jnp.int32),
                                             jnp.asarray(mask, jnp.int32),
                                             None if fh is None else jnp.asarray(fh),
                                             None if lh is None else jnp.asarray(lh))
    with torch.no_grad():
        out, balance = model(tc._nchw(img), T(ids), T(mask), first_hidden=None if fh is None else T(fh),
                             last_hidden=None if lh is None else T(lh))
    assert out.dtype == torch.float32 and out.shape == (tc.B, 7) and float(balance) == 0.0 == float(ref_balance)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    if not hidden:  # zeros stand in for the vectors not given
        with torch.no_grad():
            zeros = torch.zeros((tc.B, HIDDEN))
            assert torch.equal(out, model(tc._nchw(img), T(ids), T(mask), first_hidden=zeros, last_hidden=zeros)[0])


# --------------------------------------------------------------------------- the data mode
def _hidden_json(path, names, dims, skip=()):
    """first/last hidden states of ``dims`` (one a name, cycled) keyed by path-like names."""
    rng = np.random.default_rng(20)
    rec = {}
    for i, n in enumerate(names):
        if n in skip:
            continue
        d = dims[i % len(dims)]
        rec[f"/llm/out/{n}"] = {"first_hidden_state": rng.standard_normal(d).round(4).tolist(),
                                "last_hidden_state": rng.standard_normal(d + 1).round(4).tolist()}
    path.write_text(json.dumps(rec))
    return str(path)


@pytest.mark.parametrize("dims", [(10, 24, 40), (24,)])
def test_the_hidden_state_mode_matches_jax(tmp_path, dims):
    """Zero fill for an image the JSON does not list, zero padding of short
    vectors and truncation of long ones, record for record against JAX's dataset."""
    paths = write_dataset(tmp_path / "data", n=6, size=16)
    names = sorted(p.name for p in (tmp_path / "data" / "images").iterdir())
    hj = _hidden_json(tmp_path / "hidden.json", names, dims, skip=(names[1],))
    tok = ttok.WordPieceTokenizer.synthetic()
    ds = tdata.MultimodalDataset(paths["image_dir"], paths["json_path"], paths["label_csv"], tok,
                                 tdata.DatasetOptions(max_length=8, llm_hidden_json=hj, llm_hidden_dim=HIDDEN))
    jds = jdata.MultimodalDataset(paths["image_dir"], paths["json_path"], paths["label_csv"], tok,
                                  jdata.DatasetOptions(max_length=8, llm_hidden_json=hj, llm_hidden_dim=HIDDEN))
    assert len(ds) == len(jds) == 6
    for i in range(6):
        got, want = ds[i], jds[i]
        for k in ("first_hidden", "last_hidden"):
            assert got[k].dtype == np.float32 and got[k].shape == (HIDDEN,)
            np.testing.assert_array_equal(got[k], want[k])
    missing = [ds[i] for i in range(6) if ds[i]["image_id"] == names[1]][0]
    assert not missing["first_hidden"].any() and not missing["last_hidden"].any()
    opts = tdata.DatasetOptions.from_config(Config({"data": {"train_llm_hidden_json": hj, "llm_hidden_dim": 7},
                                                    "model": {}}), "connext", "train")
    assert opts.llm_hidden_json == hj and opts.llm_hidden_dim == 7


# --------------------------------------------------------------------------- the trainers
@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and the port Trainer from one connext config with the Mamba fusion and a
    hidden-state JSON (one image left out)."""
    root = tmp_path_factory.mktemp("mamba_fusion")
    paths = write_dataset(root / "data")
    names = sorted(p.name for p in (root / "data" / "images").iterdir())
    cfg = train_config(paths, root, "connext")
    cfg["model"]["mamba_fusion"] = {"enabled": True}
    cfg["data"].update(llm_hidden_json=_hidden_json(root / "hidden.json", names, (16, 24, 30), skip=(names[2],)),
                       llm_hidden_dim=HIDDEN)
    jt = JTrainer(JConfig(cfg), family="connext", output_dir=str(root / "jax_run"))
    pt = Trainer(Config(cfg), "connext", output_dir=str(root / "port_run"), device="cpu")
    Config(cfg).save_json(root / "c.json")
    return {"root": root, "cfg": cfg, "jax": jt, "port": pt, "config": str(root / "c.json")}


def _carry(trainers, seed):
    jt, pt = trainers["jax"], trainers["port"]
    carry_weights(jt, pt, _perturb(_np(jt.state.params), seed), trainers["root"])


@pytest.mark.parametrize("tta", [(), ("hflip", "vflip", "rot90")])
def test_eval_logits_and_tta_tiling_match_jax_eval_step(trainers, tta):
    """The Predictor's served step (the test loader's hidden vectors passed, tiled
    to the variant batch under TTA) against JAX's ``eval_step_fn`` on the same
    weights and batch."""
    _carry(trainers, 21)
    jt = trainers["jax"]
    predictor = tcommon.build_predictor(trainers["config"], "connext", device="cpu")
    predictor.load_weights(str(trainers["root"] / "carried.msgpack"))
    assert predictor.hidden
    batch = next(iter(predictor.make_test_loader()))
    assert batch["first_hidden"].shape == (B, HIDDEN)
    step = jt.eval_step_fn(tta=bool(tta), tta_transforms=tta or None)
    ref = np.asarray(step(jt.state, jax_batch(batch)))
    got = predictor.server(tta).predict(batch)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    # the vectors reach the fusion: zeros in their place move the logits
    zeroed = dict(batch, first_hidden=np.zeros_like(batch["first_hidden"]),
                  last_hidden=np.zeros_like(batch["last_hidden"]))
    assert not np.allclose(predictor.server(tta).predict(zeroed), got, atol=1e-6)


def test_a_training_step_matches_jax_grad(trainers):
    """One step's forward and backward on the JAX Trainer's augmented images, the
    batch's hidden vectors passed: the loss rtol 1e-5, the logits atol 2e-4 /
    rtol 1e-3, each tower's gradient cosine >= 0.9999 (the fusion's KAN attention,
    Mamba and projections among them), the balance loss 0."""
    jt, pt = trainers["jax"], trainers["port"]
    no_dropout(jt, pt)
    _carry(trainers, 22)
    batch = list(pt.val_loader)[-1]
    assert batch["first_hidden"].any()
    key = jax.random.PRNGKey(4)
    jimages = np.asarray(jt._preprocess_train(key, jnp.asarray(batch["image"])), np.float32)
    (jloss, (_, jlogits)), jgrads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jt.state.params, jt.state.batch_stats, jt.state.kan_state, jax_batch(batch), jnp.asarray(jimages), key)
    dev = pt.to_device(batch)
    assert set(dev) >= {"first_hidden", "last_hidden"}
    images = T(jimages.copy()).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    loss, out = pt.forward_backward(images, dev, pt.valid_mask(batch, B))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jlogits), atol=ATOL, rtol=RTOL)
    assert float(out["balance"]) == 0.0
    jg = connext_state_dict_from_jax(_np(jgrads), _np(jt.state.kan_state))
    tg = {n: p.grad for n, p in pt.model.named_parameters()}
    groups = {"image_encoder": "image_encoder.", "text_encoder": "text_encoder.", "mamba_fc": "mamba_fc.",
              "kan_attention": "mamba_fusion.attn.", "mamba": "mamba_fusion.mamba.",
              "projections": "mamba_fusion.proj_"}
    for group, prefix in groups.items():
        names = [n for n in tg if n.startswith(prefix)]
        assert names and all(tg[n] is not None for n in names), group
        c = flat_cos([tg[n].numpy() for n in names], [jg[n].numpy() for n in names])
        assert c >= 0.9999, (group, c)
