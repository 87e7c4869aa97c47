"""The port's inference entry points and checkpoints against the JAX package, on the CPU.

Set-up, once a family: ``mdhs_tpu.data.synthetic``'s dataset (10 images, 4 a
batch: the last batch 2 rows, padded), ``synthetic_config`` (tiny BERT,
float32, canvas 40 / crop 32) as a JSON config, a JAX ``Trainer`` and its
``save_checkpoint`` msgpack. Families: ``mibf``, and ``baseline`` with the
``multiscale`` and the ``mamba`` fusion (``concat``, the synthetic config's,
``bilinear`` and ``hadamard`` run through ``run_predict`` on the port's own
seeded checkpoints). The JAX CLIs run on that Trainer (their ``build_trainer``
monkeypatched to hand it over with the call's overrides); the port's with
``--device cpu``. Held equal: the submission CSVs, the evaluate JSON, the
ablation YAML; the logits within atol 2e-4, rtol 1e-3 (the float32 bound of
the ConNexT parity tests), with TTA off and on. Checkpoints cross between the packages bit for
bit, and the tolerant merge warns about the same names as ``merge_tolerant``.
"""

import csv
import json
import logging
import os

import numpy as np
import pytest
import torch
import yaml

from mdhs_tpu.cli import common as jcommon
from mdhs_tpu.cli import run_ablation_eval as jablation
from mdhs_tpu.cli import run_evaluate as jevaluate
from mdhs_tpu.cli import run_predict as jpredict
from mdhs_tpu.core import checkpoint as jckpt
from mdhs_tpu.core import convert as jconvert
from mdhs_tpu.core.config import Config as JConfig
from mdhs_tpu.core.config import load_config as jload_config
from mdhs_tpu.data.synthetic import generate_synthetic_dataset, synthetic_config
from mdhs_tpu.train.trainer import Trainer
from mdhs_tpu_torch.cli import common as tcommon
from mdhs_tpu_torch.cli import run_ablation_eval as tablation
from mdhs_tpu_torch.cli import run_evaluate as tevaluate
from mdhs_tpu_torch.cli import run_predict as tpredict
from mdhs_tpu_torch.core import checkpoint as tckpt
from mdhs_tpu_torch.core.config import Config
from mdhs_tpu_torch.models import build_model
from mdhs_tpu_torch.models.init import init_parameters

torch.set_num_threads(2)

ATOL, RTOL = 2e-4, 1e-3
TTA = ["--set", "inference.tta.enabled=true", "--set", "inference.tta.transforms=[hflip,vflip,rot90]"]
CASES = {"mibf": ("mibf", "multiscale"), "multiscale": ("baseline", "multiscale"), "mamba": ("baseline", "mamba")}


class Case:
    def __init__(self, root, family, fusion):
        self.root, self.family = root, family
        self.paths = generate_synthetic_dataset(str(root), num_images=10, image_size=48)
        cfg = synthetic_config(self.paths, str(root), batch_size=4, num_epochs=1, max_length=16)
        cfg["data"].update(canvas=40, image_size=32)
        cfg["model"]["fusion_type"] = fusion
        self.cfg = os.path.join(str(root), "config.json")
        Config(cfg).save_json(self.cfg)
        self.trainer = Trainer(JConfig(cfg), family=family, output_dir=str(root / "jax_run"), setup_data=False)
        self.ckpt = os.path.join(str(root), "weights.msgpack")
        jckpt.save_checkpoint(self.ckpt, self.trainer.checkpoint_state())

    def jax_cli(self, monkeypatch, module, argv):
        """A JAX CLI's main on this case's Trainer, its config reloaded with the call's overrides."""
        def build_trainer(config_path, family="baseline", overrides=None, setup_data=True, output_dir=None):
            assert family == self.family
            self.trainer.cfg = jload_config(config_path, overrides=overrides)
            return self.trainer

        monkeypatch.setattr(module, "build_trainer", build_trainer)
        return module.main(argv)

    def jax_logits(self, tta=False):
        tta_cfg = {"enabled": True, "transforms": ["hflip", "vflip", "rot90"]} if tta else None
        self.trainer.cfg = jload_config(self.cfg)
        return jcommon.run_prediction(self.trainer, self.trainer.make_test_loader(), tta_cfg=tta_cfg)[2]

    def argv(self, *extra):
        return ["--config", self.cfg, "--model_path", self.ckpt, *extra]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Each case made once, when a test first asks for it."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = Case(tmp_path_factory.mktemp(f"cli_{name}"), *CASES[name])
        return made[name]

    return get


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("tta", [False, True], ids=["tta_off", "tta_on"])
def test_run_predict_matches_jax(cases, name, tmp_path, monkeypatch, tta, capsys):
    case = cases(name)
    extra = TTA if tta else []
    fam = ["--family", case.family]
    case.jax_cli(monkeypatch, jpredict, case.argv("--output_path", str(tmp_path / "jax.csv"), "--compute_auc",
                                                  "--save_probs", str(tmp_path / "jax_p.csv"), *fam, *extra))
    jax_out = capsys.readouterr().out
    got = tpredict.main(case.argv("--output_path", str(tmp_path / "port.csv"), "--compute_auc", "--save_probs",
                                  str(tmp_path / "port_p.csv"), *fam, *extra, "--device", "cpu"))
    port_out = capsys.readouterr().out
    assert _rows(tmp_path / "port.csv") == _rows(tmp_path / "jax.csv") and len(_rows(tmp_path / "port.csv")) == 11
    want = case.jax_logits(tta)
    assert got["logits"].shape == want.shape == (10, 7) and got["logits"].dtype == np.float32
    np.testing.assert_allclose(got["logits"], want, atol=ATOL, rtol=RTOL)
    jp, tp = _rows(tmp_path / "jax_p.csv"), _rows(tmp_path / "port_p.csv")
    assert jp[0] == tp[0] and [r[0] for r in jp] == [r[0] for r in tp]
    np.testing.assert_allclose(np.array([r[1:] for r in tp[1:]], float), np.array([r[1:] for r in jp[1:]], float),
                               atol=2e-4)
    auc = [line for line in port_out.splitlines() if line.startswith("Macro AUC")]
    assert auc and abs(float(auc[0].split()[-1]) - float(
        [line for line in jax_out.splitlines() if line.startswith("Macro AUC")][0].split()[-1])) <= 1e-3


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_evaluate_matches_jax(cases, name, tmp_path, monkeypatch):
    case = cases(name)
    fam = ["--family", case.family]
    want = case.jax_cli(monkeypatch, jevaluate, case.argv("--report_json", str(tmp_path / "jax.json"), *fam))
    got = tevaluate.main(case.argv("--report_json", str(tmp_path / "port.json"), *fam, "--device", "cpu"))
    for out in (got, json.loads((tmp_path / "port.json").read_text())):
        assert out.keys() == want.keys()
        for k in ("confusion_matrix", "num_samples"):
            assert out[k] == want[k]
        for k in ("accuracy", "accuracy_macro", "precision_macro", "recall_macro", "f1_macro", "auroc_macro"):
            assert abs(out[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k
        np.testing.assert_allclose(out["per_class_f1"], want["per_class_f1"], atol=1e-6)


@pytest.mark.parametrize("name", ["mamba", "multiscale"])  # the CLI takes the baseline family, as in JAX
def test_run_ablation_eval_matches_jax(cases, name, tmp_path, monkeypatch):
    case = cases(name)
    want = case.jax_cli(monkeypatch, jablation, case.argv("--output", str(tmp_path / "jax.yml"), *TTA))
    got = tablation.main(case.argv("--output", str(tmp_path / "port.yml"), *TTA, "--device", "cpu"))
    assert got == want and list(got) == ["full_fusion", "image_only", "text_off"]
    with open(tmp_path / "port.yml") as f, open(tmp_path / "jax.yml") as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    # with no --output, the JAX Trainer's run directory: {log_dir}/{run_name}_{timestamp}
    tablation.main(case.argv("--device", "cpu"))
    runs = os.path.join(str(case.root), "runs")
    made = [os.path.join(runs, d, f) for d in os.listdir(runs) for f in os.listdir(os.path.join(runs, d))]
    assert any(os.path.basename(p).startswith("ablation_") and p.endswith(".yml") for p in made), made


def test_ablation_yaml_reads_back_for_awkward_values(tmp_path):
    results = {"full_fusion": 42.8571, "image_only": 100.0, "text_off": 0.0}
    path = 'C:\\weights "best": #1.pt'
    tablation.dump_results(str(tmp_path / "r.yml"), path, results)
    with open(tmp_path / "r.yml") as f:
        assert yaml.safe_load(f) == {"model_path": path, "results": results}


# --- checkpoints -----------------------------------------------------------------------------
def _port_model(case):
    p = tcommon.build_predictor(case.cfg, case.family, device="cpu")
    p.load_weights(case.ckpt)
    return p


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_msgpack_loads_into_the_port_bit_for_bit(cases, name):
    """load_state_dict_file of a JAX save_checkpoint file is *_state_dict_from_jax of its trees."""
    case = cases(name)
    p = _port_model(case)
    state = case.trainer.checkpoint_state()
    trees = {k: jax_to_np(state[k]) for k in ("params", "batch_stats", "kan_state")}
    want = tckpt.state_dict_from_jax(trees, case.family, p.model)
    got = tckpt.load_state_dict_file(case.ckpt, case.family, p.model)
    assert got.keys() == want.keys()
    sd = p.model.state_dict()
    for k in want:
        assert torch.equal(torch.as_tensor(np.asarray(got[k])), torch.as_tensor(np.asarray(want[k]))), k
        assert torch.equal(sd[k], torch.as_tensor(np.asarray(want[k])).to(sd[k].dtype)), k


def jax_to_np(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_checkpoint_is_read_by_the_jax_converters_bit_for_bit(cases, name, tmp_path):
    """save_checkpoint's file through mdhs_tpu's load_torch_state_dict + convert_*_full gives
    the JAX trees it was made from (the mamba fusion has no JAX converter: its file goes
    back through the port, and into the port's model, bit for bit)."""
    case = cases(name)
    p = _port_model(case)
    path = str(tmp_path / "port.pt")
    tckpt.save_checkpoint(path, p.model, {"family": case.family})
    assert torch.load(path, weights_only=True)["metadata"] == {"family": case.family}
    state = jax_to_np(case.trainer.checkpoint_state())
    sd = jconvert.load_torch_state_dict(path)
    if case.family == "mibf":
        params, stats = jconvert.convert_mibf_full(sd, num_bert_layers=2)
    elif case.trainer.model.cfg.fusion_type == "multiscale":
        params, stats = jconvert.convert_baseline_full(sd, fusion_type="multiscale", classifier_type="mlp",
                                                       backbone="resnet18", num_bert_layers=2)
    else:
        params = stats = None
    if params is not None:
        from flax.traverse_util import flatten_dict as flat

        for mine, theirs in ((params, state["params"]), (stats, state["batch_stats"])):
            a, b = flat(mine, sep="/"), flat(theirs, sep="/")
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    q = tcommon.build_predictor(case.cfg, case.family, device="cpu")
    q.load_weights(path)
    for k, v in p.model.state_dict().items():
        assert torch.equal(q.model.state_dict()[k], v), k


class _Warnings(logging.Handler):
    """The messages of the WARNING records that reach the root logger while attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __call__(self, fn, *args):
        root = logging.getLogger()
        root.addHandler(self)
        try:
            return fn(*args)
        finally:
            root.removeHandler(self)


@pytest.mark.parametrize("name", ["mibf"])
def test_tolerant_merge_warns_about_the_names_merge_tolerant_does(cases, name):
    """A state dict with a name dropped, one added and one of another shape: the port's merge
    and mdhs_tpu's merge_tolerant (over the same flat dicts) warn with the same messages, and
    the merge keeps the model's own value where it warned."""
    model = _port_model(cases(name)).model
    target = {k: v.clone() for k, v in model.state_dict().items()}
    names = [k for k in target if target[k].is_floating_point()]
    loaded = {k: torch.randn(v.shape) if v.is_floating_point() else v for k, v in target.items()}
    del loaded[names[0]]
    loaded["head.extra.weight"] = torch.zeros(3)
    loaded[names[1]] = torch.zeros(5, 1)
    port, jax_ = _Warnings(), _Warnings()
    merged = port(tckpt.merge_tolerant, target, loaded)
    jax_(jckpt.merge_tolerant, {k: v.numpy() for k, v in target.items()}, {k: v.numpy() for k, v in loaded.items()})
    assert sorted(port.messages) == sorted(jax_.messages) and len(port.messages) == 3, (port.messages, jax_.messages)
    assert torch.equal(merged[names[0]], target[names[0]]) and torch.equal(merged[names[1]], target[names[1]])
    assert torch.equal(merged[names[2]], loaded[names[2]].to(target[names[2]].dtype))


# --- refusals --------------------------------------------------------------------------------
@pytest.mark.parametrize("fusion", ["concat", "bilinear", "hadamard"])
def test_run_predict_serves_the_fusions(tmp_path, fusion):
    """run_predict --device cpu over a seeded port checkpoint of each fusion: the CSV's ten
    rows, and the logits of the model that was saved, bit for bit."""
    paths = generate_synthetic_dataset(str(tmp_path), num_images=10, image_size=16)
    cfg = synthetic_config(paths, str(tmp_path), max_length=8)
    cfg["model"]["fusion_type"] = fusion
    Config(cfg).save_json(tmp_path / "c.json")
    p = tcommon.build_predictor(str(tmp_path / "c.json"), "baseline", device="cpu")
    init_parameters(p.model, torch.Generator().manual_seed(0))
    tckpt.save_checkpoint(str(tmp_path / "w.pt"), p.model)
    want = tcommon.run_prediction(p, p.make_test_loader())[2]
    got = tpredict.main(["--config", str(tmp_path / "c.json"), "--model_path", str(tmp_path / "w.pt"),
                         "--output_path", str(tmp_path / "out.csv"), "--device", "cpu"])
    assert len(_rows(tmp_path / "out.csv")) == 11 and got["logits"].shape == (10, 7)
    assert np.isfinite(want).all() and np.array_equal(got["logits"], want)


@pytest.mark.parametrize("overrides, item", [
    (["model.image_encoder.backbone=mamba_vision_T"], "item 11"),
    (["data.test_llm_hidden_json=hidden.json"], "item 11"),
])
def test_unported_options_raise_naming_their_roadmap_item(tmp_path, overrides, item):
    paths = generate_synthetic_dataset(str(tmp_path), num_images=2, image_size=16)
    cfg = synthetic_config(paths, str(tmp_path), max_length=8)
    cfg["model"]["fusion_type"] = "multiscale"
    Config(cfg).save_json(tmp_path / "c.json")
    with pytest.raises(NotImplementedError, match=item):
        p = tcommon.build_predictor(str(tmp_path / "c.json"), "baseline", overrides=overrides, device="cpu")
        p.make_test_loader()


def test_cuda_without_a_card_raises_and_builds_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tpredict.main(["--config", "unused.json", "--model_path", "unused.pt", "--output_path", "x.csv"])


def test_build_model_resolves_the_served_presets():
    from mdhs_tpu_torch.core.config import load_config
    from mdhs_tpu_torch.models import model_config
    from mdhs_tpu_torch.presets import CONNEXT_HAM, HAM_FUSION_SSM, HAM_HEAD_MOE, MIBF_HAM_SERVING

    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    assert model_config(load_config(f"{root}/serving/mibf_ham_serving.yml"), "mibf", 30522) == {
        "num_labels": MIBF_HAM_SERVING.num_labels, "bert": MIBF_HAM_SERVING.bert}
    assert model_config(load_config(f"{root}/ham/ham_fusion_ssm_v1.yml"), "baseline", 30522) == HAM_FUSION_SSM
    assert model_config(load_config(f"{root}/ham/ham_head_moe_v1.yml"), "baseline", 30522) == HAM_HEAD_MOE
    assert model_config(load_config(f"{root}/connext/connext_ham.yml"), "connext", 30522) == CONNEXT_HAM
    tiny = load_config(f"{root}/mibf/mibf_ham.yml", overrides=["model.text_encoder.preset=tiny",
                                                                "training.precision=fp32"])
    from mdhs_tpu_torch.data.tokenizer import WordPieceTokenizer

    m = build_model(tiny, "mibf", WordPieceTokenizer.synthetic(30522))
    assert m.text_encoder.bert.embeddings.word_embeddings.weight.shape == (30522, 64)
    assert m.fc.weight.dtype == torch.float32 and m.textbased_cross_attention.toK_y.in_features == 64
    with pytest.raises(ValueError, match="remat"):
        model_config(load_config(f"{root}/mibf/mibf_ham.yml", overrides=["training.remat=everything"]), "mibf", 10)
