"""Training from a config and the command line, against the JAX package, on the CPU.

Set-up: 10 seeded 48 x 48 PNGs the tests write with ``data/png.py``, their
descriptions and labels (batches of 4: the last one 2 rows and padded),
``mdhs_tpu.data.synthetic.synthetic_config`` (tiny BERT, float32) at
canvas 64 / crop 56 with a cosine schedule, balanced class weights and
dropout 0 where two steps are compared; ``mibf`` here, ``connext`` in
``tests/test_torch_port_moe_train.py``. The JAX ``Trainer`` and the port's
are built from one config; weights are carried across as a JAX msgpack
checkpoint, which the port's ``Trainer.load_weights`` reads; the
augmentation's random values are the JAX sampler's own.

Tolerances: checkpoint files, indexes and metric records equal; the
pretrained towers bit for bit (the same float32 values under the same
names); the augmented images atol 1e-5 (the crop's two products in another
order); one MIBF step's loss atol 1e-4, its logits atol 2e-4 / rtol 1e-3 and
each tower's gradient cosine >= 0.999, as ``tests/test_torch_port_train.py``
(train-mode BatchNorm through ResNet50 amplifies float32 rounding);
validation's mean loss rtol 1e-4 and its accuracy equal; schedules rtol
1e-6; ``run_predict`` over the best checkpoint against the trainer's eval
forward atol 2e-4 / rtol 1e-3 (the CLI tests' bound).
"""

import dataclasses
import json
import logging
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.core import checkpoint as jckpt
from mdhs_tpu.core.config import Config as JConfig
from mdhs_tpu.data.synthetic import synthetic_config
from mdhs_tpu.train.trainer import Trainer as JTrainer
from mdhs_tpu.utils import logging as jlogging
from mdhs_tpu_torch.cli import run_predict as tpredict
from mdhs_tpu_torch.cli import run_train as trun_train
from mdhs_tpu_torch.core import checkpoint as tckpt
from mdhs_tpu_torch.core.config import Config
from mdhs_tpu_torch.core.convert import mibf_state_dict_from_jax
from mdhs_tpu_torch.data import png
from mdhs_tpu_torch.data.tokenizer import load_tokenizer
from mdhs_tpu_torch.models import bert_config_from
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.models.mibf import MIBFNet, TextEncoder
from mdhs_tpu_torch.models.resnet import ResNetClassifier
from mdhs_tpu_torch.ops.preprocess import eval_pipeline
from mdhs_tpu_torch.train.trainer import Trainer
from mdhs_tpu_torch.utils import logging as tlogging
from test_torch_port_augment import _jax_sampled_values

torch.set_num_threads(2)

CANVAS, CROP, B, SEQ = 64, 56, 4, 16
ATOL, RTOL = 2e-4, 1e-3


# --------------------------------------------------------------------------- helpers shared with the ConNexT tests
WORDS = ("lesion", "pigment", "network", "border", "irregular", "nevus", "melanoma", "dermoscopy")


def write_dataset(root, n=10, size=48, seed=0):
    """n seeded PNGs (written by the port's data/png.py), their descriptions and labels."""
    rng = np.random.default_rng(seed)
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    names = [f"img_{i:04d}.png" for i in range(n)]
    for name in names:
        png.write_png(str(img_dir / name), rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    (root / "responses.json").write_text(json.dumps(
        [{"image_info": name, "description": " ".join(rng.choice(WORDS, int(rng.integers(3, 12))))}
         for name in names]))
    (root / "labels.csv").write_text("image_id,label\n" + "".join(f"{name},{i % 7}\n" for i, name in enumerate(names)))
    return {"image_dir": str(img_dir), "json_path": str(root / "responses.json"), "label_csv": str(root / "labels.csv")}


def train_config(paths, root, family, **training) -> dict:
    """synthetic_config at canvas 64 / crop 56, cosine over 2 epochs, balanced class weights."""
    cfg = synthetic_config(paths, str(root), batch_size=B, num_epochs=2, max_length=SEQ)
    cfg["data"].update(canvas=CANVAS, image_size=CROP)
    cfg["training"].update(lr_scheduler="cosine", warmup_epochs=1, class_weight="balanced", seed=3, **training)
    cfg["output"]["log_dir"] = str(root / "runs")
    if family == "connext":
        cfg["model"]["image_encoder"]["variant"] = "port_pico"
        cfg["model"]["moe"] = {"enabled": True, "num_experts": 4, "k": 2, "expert_layers": [768, 16, 7],
                               "balance_weight": 0.05}
    return cfg


def no_dropout(jax_trainer, port_trainer):
    """Dropout 0 on both sides, so that one step of each can be compared."""
    jax_trainer.model = jax_trainer.model.clone(bert=dataclasses.replace(jax_trainer.model.bert, hidden_dropout=0.0,
                                                                         attention_dropout=0.0))
    for m in port_trainer.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def carry_weights(jax_trainer, port_trainer, params, root):
    """The JAX trainer's state with ``params`` as a msgpack file, loaded by the port's trainer."""
    jax_trainer.state = jax_trainer.state.replace(params=params)
    path = str(root / "carried.msgpack")
    jckpt.save_checkpoint(path, jax_trainer.checkpoint_state())
    port_trainer.load_weights(path)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "image_id"}


def flat_cos(a, b):
    a = np.concatenate([np.ravel(x).astype(np.float64) for x in a])
    b = np.concatenate([np.ravel(x).astype(np.float64) for x in b])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def scripted_fit(jax_trainer, port_trainer, accuracies, monkeypatch):
    """Both trainers' ``fit`` with their steps stubbed and validation scripted to
    ``accuracies``: what each writes to its metric log, by tag."""
    jt, pt = jax_trainer, port_trainer
    jit_step = lambda state, jb, rng: (state.replace(step=state.step + 1), {"loss": jnp.float32(1.0)})  # noqa: E731
    monkeypatch.setattr(jt, "train_step_fn", lambda: jit_step)
    monkeypatch.setattr(jt, "eval_step_fn", lambda **kw: None)
    jacc = iter(accuracies)
    monkeypatch.setattr(jt, "validate", lambda: (0.5, next(jacc)))
    monkeypatch.setattr(jt.ckpt, "save_last", lambda state: None)

    def port_step(batch):
        pt.step += 1
        return {"loss": torch.ones(())}

    pacc = iter(accuracies)
    monkeypatch.setattr(pt, "train_step", port_step)
    monkeypatch.setattr(pt, "_val_pass", lambda batches, keep: (0.5, next(pacc), []))
    jt.fit()
    pt.fit()
    out = []
    for path in (jt.writer.path, pt.writer.path):
        recs = [json.loads(line) for line in open(path)]
        out.append({tag: [(r["step"], r["value"]) for r in recs if r["tag"] == tag]
                    for tag in ("Accuracy/Validation", "LearningRate", "Loss/Train_Epoch")})
    return out


# --------------------------------------------------------------------------- checkpoints, records, run directory
def _stem(path):
    return re.sub(r"\.(pt|msgpack)$", "", os.path.basename(path))


@pytest.mark.parametrize("metrics", [[10.0, 30.0, 20.0, 40.0, 5.0, 35.0], [50.0, 50.0, 50.0, 50.0],
                                     [1.0, 2.0], [70.0, 60.0, 80.0, 60.0, 90.0, 10.0, 85.0]])
def test_topk_manager_keeps_what_jax_keeps(tmp_path, metrics):
    """The same metric sequence: the same files kept and evicted, the same index
    (but for the file extension), the same best; and after a restart in the same
    directory, the same retention going on."""
    half = len(metrics) // 2

    def run(mod, state, root, seq, start):
        m = mod.TopKCheckpointManager(str(root), k=3)
        saved = [m.maybe_save(start + i + 1, v, state) for i, v in enumerate(seq)]
        return m, saved

    j_state, t_state = {"params": {"w": np.ones(2, np.float32)}}, {"state_dict": {"w": torch.ones(2)}}
    for part, start in ((metrics[:half], 0), (metrics[half:], half)):  # the second manager resumes the index
        jm, jsaved = run(jckpt, j_state, tmp_path / "jax", part, start)
        tm, tsaved = run(tckpt, t_state, tmp_path / "port", part, start)
        assert [s and _stem(s) for s in jsaved] == [s and _stem(s) for s in tsaved]
        assert [(v, _stem(p)) for v, p in jm.entries] == [(v, _stem(p)) for v, p in tm.entries]
        assert _stem(jm.best_path()) == _stem(tm.best_path())
        jidx = json.load(open(tmp_path / "jax" / "checkpoints.json"))
        tidx = json.load(open(tmp_path / "port" / "checkpoints.json"))
        assert [(e["metric"], _stem(e["path"])) for e in jidx] == [(e["metric"], _stem(e["path"])) for e in tidx]
        assert sorted(_stem(f) for f in os.listdir(tmp_path / "jax") if f.startswith("epoch")) == \
            sorted(_stem(f) for f in os.listdir(tmp_path / "port") if f.startswith("epoch"))
    assert all(f.endswith(".pt") for f in os.listdir(tmp_path / "port") if f.startswith("epoch"))
    last = tm.save_last(t_state)
    assert os.path.basename(last) == "last.pt" and torch.equal(tckpt.load_torch_file(last)["w"], torch.ones(2))


@pytest.mark.parametrize("index", ["not json", '[{"metric": null, "path": "epoch_1_val_acc_1.00.pt"}]',
                                   '{"a": 1}', '[{"path": "epoch_1_val_acc_1.00.pt"}]'])
def test_topk_manager_tolerates_an_unreadable_index(tmp_path, index, caplog):
    for mod, ext in ((jckpt, ".msgpack"), (tckpt, ".pt")):
        root = tmp_path / ext[1:]
        root.mkdir()
        (root / ("epoch_1_val_acc_1.00" + ext)).write_bytes(b"x")
        (root / "checkpoints.json").write_text(index.replace(".pt", ext))
        with caplog.at_level(logging.WARNING):
            m = mod.TopKCheckpointManager(str(root), k=3)
        assert m.entries == [] and m.best_path() is None
    assert sum("ignoring unreadable checkpoints.json" in r.getMessage() for r in caplog.records) == 2


def test_metric_writer_records_match_jax(tmp_path):
    calls = [("Loss/Train_Batch", 1.25, 100), ("Accuracy/Validation", np.float32(42.5), np.int64(1)),
             ("LearningRate", 2e-05, 3), ("per_class/f1_class_0", torch.tensor(0.5).item(), 4)]
    for mod, name in ((jlogging, "jax"), (tlogging, "port")):
        (tmp_path / name).mkdir()
        w = mod.MetricWriter(str(tmp_path / name), tensorboard=False)
        for c in calls[:2]:
            w.scalar(*c)
        w.close()
        for c in calls[2:]:  # a record after close reopens the file
            w.scalar(*c)
        w.close()
    jax_lines = (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()
    port_lines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    assert port_lines == jax_lines and len(port_lines) == 4
    assert json.loads(port_lines[0]) == {"tag": "Loss/Train_Batch", "value": 1.25, "step": 100}


def test_run_directory_and_training_log(tmp_path):
    out = tlogging.setup_run_dir(str(tmp_path / "runs"), "exp")
    assert re.fullmatch(r"exp_\d{8}_\d{6}", os.path.basename(out)) and os.path.isdir(out)
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        tlogging.setup_logging(out)
        logging.getLogger("mdhs_tpu_torch.test").info("hello %d", 7)
        for h in root.handlers:
            h.flush()
        assert "INFO - hello 7" in open(os.path.join(out, "training.log")).read()
    finally:
        for h in root.handlers[:]:
            root.removeHandler(h)
            h.close()
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])


# --------------------------------------------------------------------------- MIBF: the JAX Trainer and the port's
def _torchvision_resnet50_file(path, seed):
    """A state dict in torchvision resnet50 names, its 1000-class fc included, from a seeded port tower."""
    tower = init_parameters(ResNetClassifier("resnet50", num_outputs=1000), torch.Generator().manual_seed(seed))
    sd = {k: v for k, v in tower.state_dict().items()}
    for k, v in sd.items():  # BatchNorm statistics off their identity
        if k.endswith("running_mean") or k.endswith(".bias"):
            v += 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(len(k)))
    torch.save(sd, path)
    return sd


def _hf_bert_file(path, cfg, seed, rooted):
    """A state dict in HF BertModel names (rooted at ``bert.`` or at ``embeddings.``), with a pooler,
    at the BERT a config builds."""
    bert = bert_config_from(Config(cfg), load_tokenizer(None, vocab_size=30522).vocab_size)
    g = torch.Generator().manual_seed(seed)
    sd = {k[len("bert."):]: torch.randn(v.shape, generator=g) * 0.05 for k, v in TextEncoder(bert).state_dict().items()}
    hidden = bert.hidden_size
    sd.update({"pooler.dense.weight": torch.randn(hidden, hidden, generator=g), "pooler.dense.bias": torch.zeros(hidden)})
    if rooted:
        sd = {"bert." + k: v for k, v in sd.items()}
    torch.save(sd, path)
    return sd


@pytest.fixture(scope="module")
def mibf_pair(tmp_path_factory):
    """The JAX and the port Trainer from one mibf config naming pretrained towers."""
    root = tmp_path_factory.mktemp("train_mibf")
    paths = write_dataset(root / "data")
    cfg = train_config(paths, root, "mibf")
    cfg["model"]["image_encoder"]["pretrained_path"] = str(root / "resnet50.pth")
    cfg["model"]["text_encoder"]["pretrained_path"] = str(root / "bert.bin")
    files = {"image": _torchvision_resnet50_file(cfg["model"]["image_encoder"]["pretrained_path"], 5),
             "text": _hf_bert_file(cfg["model"]["text_encoder"]["pretrained_path"], cfg, 6, rooted=True)}
    jt = JTrainer(JConfig(cfg), family="mibf", output_dir=str(root / "jax_run"))
    pt = Trainer(Config(cfg), "mibf", output_dir=str(root / "port_run"), device="cpu")
    return {"root": root, "cfg": cfg, "jax": jt, "port": pt, "files": files}


@pytest.mark.parametrize("tower", ["image", "text"])
def test_pretrained_towers_load_as_the_jax_trainer_loads_them(mibf_pair, tower):
    """A torchvision resnet50 (the 1000-class fc skipped) and an HF BertModel
    (``bert.`` rooted, its pooler dropped): the same parameters through the port's
    loader as through JAX's convert_resnet_classifier / convert_bert."""
    jt, pt = mibf_pair["jax"], mibf_pair["port"]
    jax_sd = mibf_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params),
                                      jax.tree_util.tree_map(np.asarray, jt.state.batch_stats))
    port_sd = pt.state_dict()
    prefix, file = ("image_encoder.", "resnet50") if tower == "image" else ("text_encoder.bert.", "bert")
    # the tower's names but its head (the file's 1000-class fc skipped: each side keeps its own init)
    loaded = [k for k in port_sd if k.startswith(prefix) and not k.endswith("num_batches_tracked")
              and not k.startswith("image_encoder.fc.")]
    assert loaded
    for k in loaded:
        assert torch.equal(port_sd[k].float(), jax_sd[k].float()), k
    sd = mibf_pair["files"][tower]
    key = (lambda k: k[len(prefix):]) if tower == "image" else (lambda k: "bert." + k[len(prefix):])
    assert all(torch.equal(port_sd[k].float(), sd[key(k)].float()) for k in loaded), file
    fc = port_sd["image_encoder.fc.weight"]
    assert fc.shape == (768, 2048)  # the file's 1000-class fc did not load


def test_mibf_train_step_matches_the_jax_trainer(mibf_pair):
    jt, pt, root = mibf_pair["jax"], mibf_pair["port"], mibf_pair["root"]
    from test_torch_port_models import _perturb

    no_dropout(jt, pt)
    params, stats = _perturb(jax.tree_util.tree_map(np.asarray, jt.state.params),
                             jax.tree_util.tree_map(np.asarray, jt.state.batch_stats), seed=21)
    jt.state = jt.state.replace(batch_stats=stats)
    carry_weights(jt, pt, params, root)
    batch = list(pt.val_loader)[-1]
    assert int(batch["n_valid"]) == 2  # a short last batch: two padded rows
    key = jax.random.PRNGKey(9)
    k_aff, _ = jax.random.split(key)
    jimages = np.asarray(jt._preprocess_train(key, jnp.asarray(batch["image"])))
    dev = pt.to_device(batch)
    timages = pt.augment(dev["image"], params=_jax_sampled_values(k_aff, B, CANVAS, vflip=False, degrees=15.0))
    np.testing.assert_allclose(timages.permute(0, 2, 3, 1).numpy(), jimages, atol=1e-5, rtol=0)

    grad_fn = jax.value_and_grad(jt._loss_fn, has_aux=True)
    (jloss, (_, jlogits)), jgrads = grad_fn(jt.state.params, jt.state.batch_stats, jt.state.kan_state,
                                            jax_batch(batch), jnp.asarray(jimages), key)
    images = torch.from_numpy(jimages).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    loss, out = pt.forward_backward(images, dev, pt.valid_mask(batch, B))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["image_text"].numpy(), np.asarray(jlogits), atol=ATOL, rtol=RTOL)
    jg = mibf_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                  jax.tree_util.tree_map(np.zeros_like, stats))
    tg = {n: p.grad for n, p in pt.model.named_parameters()}
    for tower in ("image_encoder", "text_encoder", "textbased_cross_attention", "imagbased_cross_attention", "fc"):
        names = [n for n in tg if n.split(".")[0] == tower]
        c = flat_cos([tg[n].numpy() for n in names], [jg[n].numpy() for n in names])
        assert c >= 0.999, (tower, c)


def test_mibf_validate_matches_the_jax_trainer(mibf_pair):
    jt, pt = mibf_pair["jax"], mibf_pair["port"]
    carry_weights(jt, pt, jt.state.params, mibf_pair["root"])
    jloss, jacc = jt.validate()
    tloss, tacc = pt.validate()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert tacc == jacc


def test_schedule_class_weights_and_early_stopping_match_jax(mibf_pair, monkeypatch, tmp_path):
    """Class weights from the train split; one LearningRate record an epoch on the
    epoch-stepped cosine over len(train_loader) steps; early stopping (patience 2,
    min_delta 1.0) at the same epoch on a scripted accuracy sequence."""
    cfg = dict(mibf_pair["cfg"])
    cfg["training"] = {**cfg["training"], "num_epochs": 8,
                       "early_stopping": {"enabled": True, "patience": 2, "min_delta": 1.0}}
    for tower in ("image_encoder", "text_encoder"):
        cfg["model"][tower] = {k: v for k, v in cfg["model"][tower].items() if k != "pretrained_path"}
    jt = JTrainer(JConfig(cfg), family="mibf", output_dir=str(tmp_path / "jax"))
    pt = Trainer(Config(cfg), "mibf", output_dir=str(tmp_path / "port"), device="cpu")
    np.testing.assert_allclose(pt.class_weights.numpy(), np.asarray(jt.class_weights), rtol=1e-6)
    assert pt.steps_per_epoch == len(pt.train_loader) == len(jt.train_loader) == 3
    jrec, trec = scripted_fit(jt, pt, [10.0, 20.0, 20.5, 21.0, 30.0, 30.5, 30.9, 31.0], monkeypatch)
    assert [s for s, _ in trec["Accuracy/Validation"]] == [s for s, _ in jrec["Accuracy/Validation"]] == [1, 2, 3, 4]
    assert [v for _, v in trec["Accuracy/Validation"]] == [v for _, v in jrec["Accuracy/Validation"]]
    for (js, jv), (ts, tv) in zip(jrec["LearningRate"], trec["LearningRate"]):
        assert js == ts and math.isclose(tv, jv, rel_tol=1e-6)
    assert len(trec["LearningRate"]) == 4 and pt.step == 12


def test_frozen_towers_take_no_update(mibf_pair, tmp_path):
    """model.image_encoder.freeze: the tower gets no gradient, no update and no
    weight decay (AdamW); the rest trains."""
    cfg = dict(mibf_pair["cfg"])
    cfg["model"] = {**cfg["model"], "image_encoder": {"freeze": True}}
    cfg["training"] = {**cfg["training"], "optimizer": "AdamW", "weight_decay": 0.5, "flatten_optimizer": True}
    pt = Trainer(Config(cfg), "mibf", output_dir=str(tmp_path), device="cpu")
    before = {k: v.clone() for k, v in pt.state_dict().items()}
    pt.train_step(next(iter(pt.train_loader)))
    after = pt.state_dict()
    for k, v in after.items():
        if k.startswith("image_encoder.") and v.is_floating_point() and "running" not in k:
            assert torch.equal(v, before[k]), k
    assert all(p.grad is None for n, p in pt.model.named_parameters() if n.startswith("image_encoder."))
    assert not torch.equal(after["text_encoder.bert.embeddings.LayerNorm.weight"],
                           before["text_encoder.bert.embeddings.LayerNorm.weight"])


# --------------------------------------------------------------------------- the command line
def test_run_train_then_predict_and_resume(tmp_path, monkeypatch):
    """run_train --device cpu over PNGs on disk: the run directory; the best
    checkpoint reloads bit for bit as the trainer's state at its epoch, and
    run_predict over it gives the trainer's eval logits; a resume from last.pt goes
    on at the saved step and schedule position for one more epoch."""
    paths = write_dataset(tmp_path / "data")
    cfg = train_config(paths, tmp_path, "mibf", log_every=2)
    cfg_path = str(tmp_path / "cfg.json")
    Config(cfg).save_json(cfg_path)

    snapshots = {}
    real = tckpt.TopKCheckpointManager.maybe_save

    def spy(self, epoch, metric, state):
        snapshots[epoch] = {k: v.clone() for k, v in state["state_dict"].items()}
        return real(self, epoch, metric, state)

    monkeypatch.setattr(tckpt.TopKCheckpointManager, "maybe_save", spy)
    trainer = trun_train.main(["--config", cfg_path, "--family", "mibf", "--device", "cpu"])
    out = trainer.output_dir
    files = set(os.listdir(out))
    assert {"training.log", "metrics.jsonl", "checkpoints.json", "last.pt", "config.json"} <= files
    assert json.load(open(os.path.join(out, "config.json"))) == json.loads(json.dumps(cfg))
    log_text = open(os.path.join(out, "training.log")).read()
    assert "Epoch 2/2" in log_text
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    tags = [r["tag"] for r in recs]
    assert tags.count("Loss/Train_Batch") == 3 and tags.count("LearningRate") == 2
    assert all(math.isfinite(r["value"]) for r in recs)
    index = json.load(open(os.path.join(out, "checkpoints.json")))
    assert 1 <= len(index) <= 3 and index == sorted(index, key=lambda e: -e["metric"])
    best = os.path.join(out, index[0]["path"])
    epoch = int(re.match(r"epoch_(\d+)_", index[0]["path"]).group(1))
    saved = tckpt.load_torch_file(best)
    assert saved.keys() == snapshots[epoch].keys()
    assert all(torch.equal(saved[k], snapshots[epoch][k]) for k in saved)
    fresh = MIBFNet(7, trainer.model.text_encoder.bert.cfg)
    tckpt.load_weights(fresh, best, "mibf")
    assert all(torch.equal(v, saved[k]) for k, v in fresh.state_dict().items())

    # run_predict over the best checkpoint against the trainer's own eval forward on those weights
    pred = tpredict.main(["--config", cfg_path, "--model_path", best, "--family", "mibf", "--device", "cpu",
                          "--output_path", str(tmp_path / "sub.csv")])
    trainer.load_weights(best)
    trainer.model.eval()
    logits = []
    with torch.inference_mode():
        for b in trainer.val_loader:  # the test split's records, in its order
            dev = trainer.to_device(b)
            img = eval_pipeline(dev["image"], CROP, normalize=False, dtype=torch.float32)
            logits.append(trainer.model(img, dev["input_ids"], dev["attention_mask"])["image_text"][: int(b["n_valid"])])
    np.testing.assert_allclose(pred["logits"], torch.cat(logits).numpy(), atol=ATOL, rtol=RTOL)

    # resume from last.pt: the masters, step, optimizer state and generators come back ...
    last_path = os.path.join(out, "last.pt")
    state = torch.load(last_path, map_location="cpu", weights_only=True)
    assert state["resume"]["step"] == 6 and state["resume"]["epoch"] == 2
    back = Trainer(Config(cfg).merged({"training": {"resume_from": last_path}}), "mibf",
                   output_dir=str(tmp_path / "back"), device="cpu")
    assert back.step == 6 and back.epoch == 2
    assert all(torch.equal(v, state["state_dict"][k]) for k, v in back.checkpoint_state()["state_dict"].items())
    assert torch.equal(back.generator.get_state(), state["resume"]["rng"]["augment"])
    opt = back.optimizer.state_dict()["state"]
    assert all(torch.equal(opt[i]["exp_avg"], s["exp_avg"]) for i, s in state["resume"]["optimizer"]["state"].items())
    # ... and run_train goes on for one more epoch at the saved step and schedule position
    resumed = trun_train.main(["--config", cfg_path, "--family", "mibf", "--device", "cpu",
                               "--set", f"training.resume_from={last_path}", "--set", "training.num_epochs=3"])
    assert resumed.step == 9 and resumed.epoch == 3
    recs = [json.loads(line) for line in open(os.path.join(resumed.output_dir, "metrics.jsonl"))]
    assert [r["step"] for r in recs if r["tag"] == "Loss/Train_Epoch"] == [3]
    # the last step ran at lr(8): the epoch-stepped cosine of 3 epochs at epoch 8 // 3 = 2
    assert math.isclose(resumed.optimizer.param_groups[0]["lr"], 1e-3 * 0.5 * (1 + math.cos(math.pi * 2 / 3)),
                        rel_tol=1e-12)
    assert "resumed from" in open(os.path.join(resumed.output_dir, "training.log")).read()


# --------------------------------------------------------------------------- refusals
@pytest.mark.parametrize("overrides, exc, match", [
    (["data.multi_view.enabled=true"], ValueError, "sequence encoder"),
    (["data.augment.host=true"], NotImplementedError, "Queue 1 item 8"),
    (["model.tabular.enabled=true"], ValueError, "metadata_csv"),
    (["training.flatten_optimizer=sideways"], ValueError, "flatten_optimizer"),
    (["training.optimizer=Muon"], NotImplementedError, "Queue 1 item 8"),
    (["parallel.n_model=2"], NotImplementedError, "Queue 1 item 12"),
])
def test_unported_training_options_raise(tmp_path, overrides, exc, match):
    paths = write_dataset(tmp_path / "data", n=2)
    path = str(tmp_path / "c.json")
    Config(train_config(paths, tmp_path, "mibf")).save_json(path)
    sets = [arg for o in overrides for arg in ("--set", o)]
    with pytest.raises(exc, match=match):
        trun_train.main(["--config", path, "--family", "mibf", "--device", "cpu", *sets])


def test_run_train_refuses_the_baseline_family_and_a_multi_process_launch(monkeypatch, tmp_path):
    """The baseline family trains (tests/test_torch_port_baseline_train.py); what it
    still lacks, here the Muon optimizer, raises before anything is built, as a
    multi-process launch does."""
    path = str(tmp_path / "c.json")
    cfg = {"model": {"fusion_type": "concat"}, "training": {"optimizer": "Muon"}}
    Config(cfg).save_json(path)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        trun_train.main(["--config", path, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        Trainer(Config(cfg), "baseline", device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        trun_train.main(["--config", "never_read.json", "--family", "mibf", "--device", "cpu"])


def test_trainer_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        trun_train.main(["--config", "never_read.json", "--family", "mibf"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Trainer(Config({}), "mibf")


# --------------------------------------------------------------------------- augmentation, pretrained weights in the CLIs, profile
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_application_matches_jax(seed):
    """apply_color_jitter on the factors mdhs_tpu/ops/augment.py::color_jitter draws
    from its key (re-drawn with the same splits), over pixels that are gray, black,
    white and saturated besides random ones: atol 1e-6 (float32 HSV of values in [0, 1])."""
    from mdhs_tpu.ops import augment as jaug
    from mdhs_tpu_torch.ops import augment as taug

    n = 4
    x = np.random.default_rng(seed).uniform(0.0, 1.0, (n, 12, 12, 3)).astype(np.float32)
    x[0, :3] = 0.5
    x[1, :2] = [1.0, 0.0, 0.0]
    x[2, :2] = 0.0
    x[3, :2] = 1.0
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jaug.color_jitter(key, jnp.asarray(x)))
    kb, kc, ks, kh = jax.random.split(key, 4)
    f = [jax.random.uniform(k_, (n, 1, 1, 1), minval=0.8, maxval=1.2) for k_ in (kb, kc, ks)]
    f.append(jax.random.uniform(kh, (n, 1, 1), minval=-0.1, maxval=0.1))
    p = taug.ColorJitter(*(torch.from_numpy(np.asarray(a).reshape(n).copy()) for a in f))
    out = taug.apply_color_jitter(torch.from_numpy(x), p).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    drawn = taug.sample_color_jitter(n, torch.Generator().manual_seed(seed))
    assert all(float(t.min()) >= 0.8 and float(t.max()) <= 1.2 for t in drawn[:3])
    assert float(drawn.hue.abs().max()) <= 0.1


def test_the_eval_clis_load_pretrained_towers_named_in_the_config(tmp_path):
    """Predictor (run_predict, run_evaluate) loads model.text_encoder.pretrained_path
    as the trainer does (it raised for them before)."""
    from mdhs_tpu_torch.cli import common as tcommon

    paths = write_dataset(tmp_path / "data", n=2)
    cfg = train_config(paths, tmp_path, "mibf")
    cfg["model"]["text_encoder"]["pretrained_path"] = str(tmp_path / "bert.bin")
    sd = _hf_bert_file(cfg["model"]["text_encoder"]["pretrained_path"], cfg, 8, rooted=False)
    Config(cfg).save_json(tmp_path / "c.json")
    model = tcommon.build_predictor(str(tmp_path / "c.json"), "mibf", device="cpu").model
    got = model.state_dict()
    assert all(torch.equal(got["text_encoder.bert." + k], v) for k, v in sd.items() if not k.startswith("pooler."))


def test_a_torchvision_convnext_file_raises_naming_its_item(tmp_path):
    """A torchvision ConvNeXt (``features.*``) tower is read (tests/test_torch_port_convert.py
    loads one); a file lacking its tensors raises naming the key and the namings it takes."""
    from mdhs_tpu_torch.core import pretrained
    from mdhs_tpu_torch.models.connext import ConNexTClassifier, ConNexTConfig

    path = str(tmp_path / "tv.pth")
    torch.save({"features.0.0.weight": torch.zeros(1), "classifier.2.weight": torch.zeros(1)}, path)
    cfg = Config({"model": {"image_encoder": {"pretrained_path": path}}})
    with pytest.raises(ValueError, match=r"ConvNeXt \(HF or torchvision\) state dict for the 'connext' family "
                                         r"\(missing key '0.0.bias'\)"):
        pretrained.load_pretrained(ConNexTClassifier(ConNexTConfig(), device="meta"), cfg, "connext")
    with pytest.raises(ValueError, match="does not look like a torchvision resnet50 state dict for the 'mibf'"):
        pretrained.load_pretrained(MIBFNet(7, bert_config_from(Config({"model": {"text_encoder": {"preset": "tiny"}}}),
                                                               512)), cfg, "mibf")


def test_an_nvidia_mamba_vision_file_loads_into_the_baseline_tower(tmp_path, monkeypatch):
    """``model.image_encoder.pretrained_path`` of a ``mamba_vision_*`` baseline: an
    NVIDIA state dict (the Hugging Face wrapper's ``model.`` prefix, its ``norm`` and
    ``head`` dropped) loads into ``image_encoder.model.`` bit for bit, the values
    JAX's ``convert_mamba_vision`` reads from the file; a file of another network
    raises naming the backbone."""
    from mdhs_tpu.core.convert import convert_mamba_vision
    from mdhs_tpu.models import mamba_vision as jmv
    from mdhs_tpu_torch.core import pretrained
    from mdhs_tpu_torch.core.convert import mamba_vision_state_dict_from_jax
    from mdhs_tpu_torch.models import build_model
    from mdhs_tpu_torch.models import mamba_vision as tmv

    spec = dict(dim=16, in_dim=8, depths=(1, 1, 2, 2), heads=(2, 2, 2, 2), window=(4, 4, 2, 2), layer_scale=1e-5)
    monkeypatch.setitem(tmv.MAMBA_VISION_SPECS, "PICO", spec)
    monkeypatch.setitem(jmv.MAMBA_VISION_SPECS, "PICO", spec)
    tower = init_parameters(tmv.MambaVision("PICO", num_classes=1000, head=True), torch.Generator().manual_seed(7))
    sd = {"model." + k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
          if v.is_floating_point() else v for i, (k, v) in enumerate(tower.state_dict().items())}
    path = str(tmp_path / "mambavision_pico.pth")
    torch.save(sd, path)
    paths = write_dataset(tmp_path / "data", n=2)
    cfg = train_config(paths, tmp_path, "baseline")
    cfg["model"]["image_encoder"].update(backbone="mamba_vision_PICO", pretrained_path=path)
    cfg = Config(cfg)
    model = build_model(cfg, "baseline", load_tokenizer(None, vocab_size=30522), dtype=torch.float32)
    assert pretrained.load_pretrained(model, cfg, "baseline") == [path]
    got = {k[len("image_encoder.model."):]: v for k, v in model.state_dict().items()
           if k.startswith("image_encoder.model.")}
    assert got and not any(k.startswith(("norm.", "head.")) for k in got)
    for k, v in got.items():
        assert torch.equal(v, sd["model." + k]), k
    np_sd = {k[len("model."):]: v.numpy() for k, v in sd.items()}
    jp, js = convert_mamba_vision(np_sd, variant="PICO")
    via_jax = mamba_vision_state_dict_from_jax({k: v for k, v in jp.items() if k not in ("norm", "head")},
                                               {k: v for k, v in js.items() if k != "norm"})
    assert set(via_jax) == {k for k in got if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(via_jax[k], got[k]) for k in via_jax)
    torch.save({"conv1.weight": torch.zeros(1)}, str(tmp_path / "resnet.pth"))
    cfg.set("model.image_encoder.pretrained_path", str(tmp_path / "resnet.pth"))
    with pytest.raises(ValueError, match="NVIDIA mamba_vision_PICO state dict for the 'baseline' family"):
        pretrained.load_pretrained(model, cfg, "baseline")


def test_training_profile_writes_a_trace(tmp_path):
    """training.profile: the first ``steps`` steps' torch.profiler trace in the run directory."""
    paths = write_dataset(tmp_path / "data", n=4)
    cfg = train_config(paths, tmp_path, "mibf", num_epochs=1, profile={"enabled": True, "steps": 1})
    pt = Trainer(Config(cfg), "mibf", output_dir=str(tmp_path / "run"), device="cpu")
    pt.fit()
    trace = tmp_path / "run" / "profile" / "trace.json"
    assert trace.exists() and "traceEvents" in trace.read_text()[:4096]
