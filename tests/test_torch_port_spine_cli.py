"""The Spine and HAM branch configurations through the port's entry points, on
the CPU in float32, against the JAX package.

Each of ``spine_sequence_lstm_v1``, ``spine_sequence_transformer_v1``,
``spine_multi_view_v1``, ``spine_pseudo25d_v1``, ``spine_global_local_v1``,
``spine_gate_entropy_v1``, ``ham_gate_entropy_v1`` and ``ham_tabular_v1``
is cut to CPU size: its ``model`` branches and ``data`` modes laid over
``mdhs_tpu.data.synthetic``'s config (ResNet18, the tiny BERT, hidden 32,
canvas 56 -> 48, batches of 4, dropout 0) on its dataset with
``sequence_groups`` (10 JPEGs in groups of five slices, a metadata CSV).
For each: the model configuration equals the JAX ``BaselineConfig`` of the
full JSON configuration and of the cut one (the tabular width the JAX
Trainer takes from its loader); ``run_train`` one step, then ``run_predict``
with TTA and ``run_evaluate`` over its best checkpoint. For the sequence
LSTM and the tabular configuration, the port's Trainer against the JAX
Trainer on the same weights and batch (the JAX sampler's augmentation of the
B * T stack): one step's loss rtol 1e-5, logits atol 2e-4 / rtol 1e-3, each
tower's gradient cosine >= 0.9999; ``run_predict`` against the JAX
``run_prediction`` within atol 2e-4 / rtol 1e-3, with TTA for the tabular
one (its record tiled over the variants); for the sequence one the port's
5-D TTA against the JAX forward of each slice flipped. The tabular artifact
(``export_serving``) answers as its live model bit for bit, and
``run_serve`` writes ``run_predict``'s CSV.
"""

import copy
import csv
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.cli import common as jcommon
from mdhs_tpu.core import checkpoint as jckpt
from mdhs_tpu.core.config import Config as JConfig
from mdhs_tpu.core.config import load_config as jload_config
from mdhs_tpu.data.datasets import build_tabular_map as jtabular_map
from mdhs_tpu.data.synthetic import generate_synthetic_dataset, synthetic_config
from mdhs_tpu.models.baseline import BaselineConfig as JBaselineConfig
from mdhs_tpu.train.trainer import Trainer as JTrainer
from mdhs_tpu.train.trainer import bert_config_from as jbert_config_from
from mdhs_tpu_torch.cli import export_serving as texport
from mdhs_tpu_torch.cli import run_evaluate as tevaluate
from mdhs_tpu_torch.cli import run_predict as tpredict
from mdhs_tpu_torch.cli import run_serve as tserve
from mdhs_tpu_torch.cli import run_train as trun_train
from mdhs_tpu_torch.core.config import Config
from mdhs_tpu_torch.core.config import load_config
from mdhs_tpu_torch.core.convert import baseline_state_dict_from_jax
from mdhs_tpu_torch.data.datasets import tabular_dim
from mdhs_tpu_torch.models import model_config
from mdhs_tpu_torch.ops import augment as taug
from mdhs_tpu_torch.serving import ServingModel
from mdhs_tpu_torch.train.trainer import Trainer
from test_torch_port_augment import _jax_sampled_values
from test_torch_port_train_cli import flat_cos, jax_batch

torch.set_num_threads(2)
T = torch.from_numpy
REPO = Path(__file__).resolve().parent.parent
CANVAS, CROP, B = 56, 48, 4
ATOL, RTOL = 2e-4, 1e-3
NAMES = ("spine_sequence_lstm_v1", "spine_sequence_transformer_v1", "spine_multi_view_v1", "spine_pseudo25d_v1",
         "spine_global_local_v1", "spine_gate_entropy_v1", "ham_gate_entropy_v1", "ham_tabular_v1")
BRANCHES = ("fusion_type", "classifier_type", "num_classes", "gate", "sequence_encoder", "global_local", "tabular")
TOWERS = ("image_encoder", "text_encoder", "fusion", "classifier", "sequence_encoder", "tabular_encoder",
          "tabular_fusion")


def full_config(name):
    return load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json")


def tiny_config(name, paths, root) -> dict:
    """``name``'s branches and data modes over the synthetic config, at CPU size."""
    real = full_config(name).to_dict()
    cfg = synthetic_config(paths, str(root), num_classes=real["model"]["num_classes"], batch_size=B, num_epochs=1,
                           max_length=12)
    cfg["data"].update(canvas=CANVAS, image_size=CROP, train_label_csv=paths["train_csv"])
    for k in ("sequence", "multi_view", "pseudo_2p5d"):
        if k in real["data"]:
            cfg["data"][k] = copy.deepcopy(real["data"][k])
    if "sequence" in cfg["data"]:
        cfg["data"]["sequence"]["offsets"] = [-1, 0, 1]
    cfg["model"].update({k: copy.deepcopy(real["model"][k]) for k in BRANCHES if k in real["model"]})
    cfg["model"]["mlp_head"]["dropout"] = 0.0
    if "sequence_encoder" in cfg["model"]:
        cfg["model"]["sequence_encoder"].update(hidden_dim=32, dropout=0.0)
    if "tabular" in cfg["model"]:
        cfg["model"]["tabular"].update(hidden_dim=16, dropout=0.0)
    cfg["training"].update(seed=3, log_every=1)
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("spine_cli")
    paths = generate_synthetic_dataset(str(root), num_images=10, image_size=48, num_classes=6, sequence_groups=True)
    rows = list(csv.reader(open(paths["label_csv"])))
    train = root / "train.csv"
    train.write_text("\n".join(",".join(r) for r in rows[:B + 1]) + "\n")  # one batch: one step an epoch
    return {**paths, "train_csv": str(train), "root": root}


def _jax_model_config(cfg: dict, width: int):
    jc = JConfig(cfg)
    bert = jbert_config_from(jc, 30522)
    return JBaselineConfig.from_config(jc, tabular_input_dim=width, bert=bert)


@pytest.mark.parametrize("name", NAMES)
def test_the_model_configuration_is_the_jax_one(name, data):
    """The full configuration (the metadata CSV the test's) and its CPU cut build the
    JAX ``BaselineConfig``, the tabular width from the metadata CSV as JAX takes it."""
    for cfg in (full_config(name).to_dict(), tiny_config(name, data, data["root"])):
        cfg["data"]["metadata_csv"] = data["metadata_csv"]
        tab = cfg["model"].get("tabular", {})
        width = jtabular_map(data["metadata_csv"], tab.get("fields", ["age", "sex", "localization"]))[1] \
            if tab.get("enabled") else 0
        assert tabular_dim(Config(cfg)) == width
        got = dataclasses.replace(model_config(Config(cfg), "baseline", 30522), tabular_input_dim=width or 0)
        want = _jax_model_config(cfg, width)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        got.check_ported()


def _write(cfg, path):
    Config(cfg).save_json(path)
    return str(path)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("name", NAMES)
def test_run_train_one_step_then_predict_and_evaluate(name, data, tmp_path, capsys):
    cfg = tiny_config(name, data, tmp_path)
    path = _write(cfg, tmp_path / "cfg.json")
    trun_train.main(["--config", path, "--device", "cpu"])
    run = next((tmp_path / "runs").iterdir())
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [x["value"] for x in lines if x["tag"] == "Loss/Train_Batch"]
    assert len(losses) == 1 and np.isfinite(losses[0])
    best = str(run / json.loads((run / "checkpoints.json").read_text())[0]["path"])
    tta = ["--set", "inference.tta.enabled=true", "--set", "inference.tta.transforms=[hflip,vflip,rot90]"]
    out = tpredict.main(["--config", path, "--model_path", best, "--output_path", str(tmp_path / "p.csv"),
                         "--device", "cpu", *tta])
    assert out["logits"].shape == (10, cfg["model"]["num_classes"]) and np.isfinite(out["logits"]).all()
    assert [r[0] for r in _rows(tmp_path / "p.csv")[1:]] == out["image_ids"]
    report = tevaluate.main(["--config", path, "--model_path", best, "--device", "cpu"])
    assert report["num_samples"] == 10 and np.isfinite(report["f1_macro"])
    capsys.readouterr()


# --------------------------------------------------------------------------- against the JAX Trainer
def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("bias", "mean"):
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        if name in ("scale", "var", "act_base"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def pairs(data, tmp_path_factory):
    """A JAX and a port Trainer on one cut configuration each, the JAX init's perturbed
    weights carried into the port's through a msgpack checkpoint, dropout off."""
    made = {}
    for name in ("spine_sequence_lstm_v1", "ham_tabular_v1"):
        root = tmp_path_factory.mktemp(name)
        cfg = tiny_config(name, data, root)
        cfg["data"]["metadata_csv"] = data["metadata_csv"]
        jt = JTrainer(JConfig(cfg), family="baseline", output_dir=str(root / "jax_run"))
        jt.model = jt.model.clone(cfg=dataclasses.replace(
            jt.model.cfg, bert=dataclasses.replace(jt.model.cfg.bert, hidden_dropout=0.0, attention_dropout=0.0)))
        pt = Trainer(Config(cfg), "baseline", output_dir=str(root / "port_run"), device="cpu")
        for m in pt.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        jt.state = jt.state.replace(params=_perturb(jt.state.params, 5), batch_stats=_perturb(jt.state.batch_stats, 6))
        ckpt = str(root / "carried.msgpack")
        jckpt.save_checkpoint(ckpt, jt.checkpoint_state())
        pt.load_weights(ckpt)
        made[name] = {"jax": jt, "port": pt, "cfg": cfg, "root": root, "ckpt": ckpt,
                      "path": _write(cfg, root / "cfg.json")}
    return made


@pytest.mark.parametrize("name", ["spine_sequence_lstm_v1", "ham_tabular_v1"])
def test_train_step_matches_the_jax_trainer(pairs, name):
    pair = pairs[name]
    jt, pt = pair["jax"], pair["port"]
    batch = next(iter(pt.train_loader))
    assert ("tabular" in batch) == (name == "ham_tabular_v1") and batch["image"].ndim == (5 if "sequence" in name else 4)
    n_img = int(np.prod(batch["image"].shape[:-3]))  # B, or B * T for a stack
    key = jax.random.PRNGKey(9)
    k_aff, k_col = jax.random.split(key)
    jimages = np.asarray(jt._preprocess_train(key, jnp.asarray(batch["image"])), np.float32)
    kb, kc, ks, kh = jax.random.split(k_col, 4)
    f = [jax.random.uniform(k_, (n_img, 1, 1, 1), minval=0.8, maxval=1.2) for k_ in (kb, kc, ks)]
    f.append(jax.random.uniform(kh, (n_img, 1, 1), minval=-0.1, maxval=0.1))
    jitter = taug.ColorJitter(*(T(np.asarray(a).reshape(n_img).copy()) for a in f))
    dev = pt.to_device(batch)
    timages = pt.augment(dev["image"], params=_jax_sampled_values(k_aff, n_img, CANVAS, vflip=True, degrees=45.0),
                         jitter=jitter)
    perm = (0, 1, 3, 4, 2) if timages.ndim == 5 else (0, 2, 3, 1)
    np.testing.assert_allclose(timages.permute(*perm).numpy(), jimages, atol=1e-5, rtol=0)
    (jloss, (_, jlogits)), jgrads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jt.state.params, jt.state.batch_stats, jt.state.kan_state, jax_batch(batch), jnp.asarray(jimages), key)
    iperm = (0, 1, 4, 2, 3) if timages.ndim == 5 else (0, 3, 1, 2)
    loss, out = pt.forward_backward(T(jimages.copy()).permute(*iperm), dev, pt.valid_mask(batch, B))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jlogits), atol=ATOL, rtol=RTOL)
    c = jt.model.cfg
    jg = baseline_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                      jax.tree_util.tree_map(np.asarray, jt.state.batch_stats), None, c.fusion_type,
                                      c.classifier_type)
    tg = {n: p.grad for n, p in pt.model.named_parameters()}
    for tower in TOWERS:
        names = [n for n in tg if n.split(".")[0] == tower]
        if names:
            assert flat_cos([tg[n].numpy() for n in names], [jg[n].numpy() for n in names]) >= 0.9999, tower


def _jax_logits(jt, cfg_path, tta):
    jt.cfg = jload_config(cfg_path)
    tta_cfg = {"enabled": True, "transforms": ["hflip", "vflip", "rot90"]} if tta else None
    return jcommon.run_prediction(jt, jt.make_test_loader(), tta_cfg=tta_cfg)[2]


@pytest.mark.parametrize("name, tta", [("spine_sequence_lstm_v1", False), ("ham_tabular_v1", False),
                                       ("ham_tabular_v1", True)])
def test_run_predict_matches_the_jax_trainer(pairs, name, tta, tmp_path):
    pair = pairs[name]
    extra = ["--set", "inference.tta.enabled=true", "--set", "inference.tta.transforms=[hflip,vflip,rot90]"] \
        if tta else []
    got = tpredict.main(["--config", pair["path"], "--model_path", pair["ckpt"], "--output_path",
                         str(tmp_path / "p.csv"), "--device", "cpu", *extra])
    np.testing.assert_allclose(got["logits"], _jax_logits(pair["jax"], pair["path"], tta), atol=ATOL, rtol=RTOL)


def test_sequence_tta_flips_each_slice(pairs, tmp_path):
    """The port's hflip TTA on a (B, T, S, S, 3) stack is the mean of the forwards of
    the stack and of the stack with each slice flipped left to right (the JAX
    function's axes do not fit a stack: ROADMAP Queue 3)."""
    pair = pairs["spine_sequence_lstm_v1"]
    jt = pair["jax"]
    got = tpredict.main(["--config", pair["path"], "--model_path", pair["ckpt"], "--output_path",
                         str(tmp_path / "p.csv"), "--device", "cpu", "--set", "inference.tta.enabled=true"])
    jt.cfg = jload_config(pair["path"])
    step = jt.eval_step_fn()
    want = []
    for batch in jt.make_test_loader():
        jb = jax_batch(batch)
        flipped = dict(jb, image=jb["image"][:, :, :, ::-1, :])
        both = (np.asarray(step(jt.state, jb)) + np.asarray(step(jt.state, flipped))) / 2
        want.append(both[:int(batch["n_valid"])])
    np.testing.assert_allclose(got["logits"], np.concatenate(want), atol=ATOL, rtol=RTOL)


def test_tabular_artifact_answers_as_its_live_model(pairs, tmp_path, capsys):
    pair = pairs["ham_tabular_v1"]
    art = str(tmp_path / "tab.pt2")
    info = texport.main(["--config", pair["path"], "--model_path", pair["ckpt"], "--output", art, "--batch_size", "4",
                         "--device", "cpu", "--smoke_test"])
    width = pair["port"].model.cfg.tabular_input_dim
    assert info["inputs"]["tabular"] == [[4, width], "float32"] and info["smoke_finite"]
    loaded = ServingModel.load(art, "cpu")
    predictor = tpredict.build_predictor(pair["path"], device="cpu")
    predictor.load_weights(pair["ckpt"])
    live = predictor.server()
    for batch in predictor.make_test_loader():
        req = {k: np.asarray(batch[k]) for k in ("image", "input_ids", "attention_mask", "tabular")}
        np.testing.assert_array_equal(loaded.predict(req), live.predict(req))
        req["tabular"] = req["tabular"] + 1.0  # the record moves the logits
        assert not np.array_equal(loaded.predict(req), live.predict({**req, "tabular": req["tabular"] - 1.0}))
    tserve.main(["--artifact", art, "--config", pair["path"], "--output_path", str(tmp_path / "s.csv"),
                 "--device", "cpu"])
    tpredict.main(["--config", pair["path"], "--model_path", pair["ckpt"], "--output_path", str(tmp_path / "p.csv"),
                   "--device", "cpu"])
    assert _rows(tmp_path / "s.csv") == _rows(tmp_path / "p.csv")
    capsys.readouterr()
