"""The exported serving artifact on the CPU: the mdhs custom ops, export_serving, ServingModel.load, run_serve.

- (a) each of the eight ``torch.ops.mdhs`` ops passes ``torch.library.opcheck``
  at small shapes, and its CPU kernel is its plain version bit for bit;
- (b) MIBF exact, MIBF int8 with ``fast_math``, MIBF under "flash", the
  baseline's ``mamba`` + ``mlp``, ``multiscale`` + ``moe`` and ``multiscale`` +
  ``kan`` (base.yml's GroupKAN head, plain tensor ops) and a pico
  ConNexT with the MoE head (one narrow BERT layer, a 64^2 crop): the live
  ``ServingModel``'s ``ServeFunction`` exported, written, loaded with
  ``ServingModel.load``, and its logits equal to the live ones bit for bit, on
  a full batch and on 3 rows of a batch of 4, one case with TTA;
- (c) against the JAX package, on ``tests/test_torch_port_cli.py``'s set-up (a
  synthetic dataset, its JSON config, a JAX Trainer and its msgpack): JAX's
  ``export_serving.main`` and ``load_and_run`` beside the port's
  ``export_serving.main --device cpu`` of the same msgpack, logits within atol
  2e-4, rtol 1e-3 (``test_torch_port_cli.py``'s float32 bound), and both ``run_serve`` CSVs equal;
- (d) the runtime around a loaded artifact, as ``tests/test_serving.py`` holds
  the JAX one: stream equals sync in order, partial-batch padding, input
  validation, the format tag, and a CPU artifact refused on "cuda" without a
  card;
- (e) a fresh interpreter that cannot import ``mdhs_tpu_torch.models`` or
  ``modules`` loads an artifact and runs ``run_serve``, leaving jax, mdhs_tpu,
  yaml and msgpack out of ``sys.modules``;
- (f) the caches: the artifact holds the int8 weights and the stacked MoE bank
  as constants, which two requests leave as they were, no request reads a
  float BERT weight under int8, and an export keeps no traced tensor in
  ``imagenet_stats``.
"""

import contextlib
import csv
import dataclasses
import io
import json
import operator
import os
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from mdhs_tpu.cli import export_serving as jexport
from mdhs_tpu.cli import run_serve as jserve
from mdhs_tpu.data.datasets import build_tabular_map as jtabular_map
from mdhs_tpu_torch.cli import export_serving as texport
from mdhs_tpu_torch.cli import run_serve as tserve
from mdhs_tpu_torch.models import mamba_vision as tmv
from mdhs_tpu_torch.models.baseline import BaselineConfig, MultimodalBaselineModel
from mdhs_tpu_torch.models.bert import BertConfig
from mdhs_tpu_torch.models.connext import ConNexTClassifier
from mdhs_tpu_torch.models.convnext import register_convnext_variant
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.models.mibf import MIBFNet
from mdhs_tpu_torch.ops import preprocess
from mdhs_tpu_torch.presets import CONNEXT_HAM
from mdhs_tpu_torch.serving import FORMAT, ServingModel, read_meta
from test_torch_port_cli import ATOL, RTOL, Case
from test_torch_port_cli import CASES as CLI_CASES
from test_torch_port_cuda import OPS, PLAIN, op_args

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CANVAS, CROP, SEQ, LABELS, BATCH = 72, 64, 12, 7, 4
TINY_BERT = BertConfig(vocab_size=128, num_hidden_layers=1, intermediate_size=128, max_position_embeddings=128)
CPU = torch.device("cpu")


# --- (a) the ops ------------------------------------------------------------------------------
@pytest.mark.parametrize("name", OPS)
def test_op_passes_opcheck_and_its_cpu_kernel_is_the_plain_version(name):
    op = getattr(torch.ops.mdhs, name).default
    args = op_args(name, CPU)
    torch.library.opcheck(op, args)
    got, want = op(*args), PLAIN[name](*args)
    for g, w in zip(*((x if isinstance(x, tuple) else (x,)) for x in (got, want))):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_ops_have_no_kernel_for_another_device():
    """CPU, CUDA and fake only: a meta tensor goes to the fake, no composite takes any other key."""
    out = torch.ops.mdhs.fused_attention.default(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                                                   for a in op_args("fused_attention", CPU)))
    assert out.device.type == "meta" and out.shape == (2, 24, 128)
    for name in OPS:
        op = getattr(torch.ops.mdhs, name).default
        assert not op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CompositeImplicitAutograd), name
        assert not op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CompositeExplicitAutograd), name
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CPU), name
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CUDA), name


# --- (b) artifact == live, bit for bit ---------------------------------------------------------
def _mibf(bert):
    return init_parameters(MIBFNet(LABELS, bert), torch.Generator().manual_seed(0)).eval()


def _baseline(fusion, head):
    cfg = BaselineConfig(hidden_dim=32, num_heads=4, fusion_type=fusion, classifier_type=head,
                         text_feature_dim=TINY_BERT.hidden_size, bert=TINY_BERT)
    return init_parameters(MultimodalBaselineModel(cfg), torch.Generator().manual_seed(1)).eval()


def _connext():
    register_convnext_variant("pico", (1, 1, 1, 1), (8, 8, 8, 16))
    cfg = dataclasses.replace(CONNEXT_HAM, convnext_variant="pico", moe_expert_layers=(768, 16, 7), bert=TINY_BERT)
    return init_parameters(ConNexTClassifier(cfg), torch.Generator().manual_seed(2)).eval()


def _mamba_vision_basic():
    """The baseline's basic fusion on a pico MambaVision tower, whose token stages pad (windows 3)."""
    tmv.MAMBA_VISION_SPECS.setdefault("export_pico", dict(dim=8, in_dim=8, depths=(1, 1, 2, 2), heads=(2, 2, 2, 2),
                                                          window=(4, 4, 3, 3), layer_scale=None))
    cfg = BaselineConfig(hidden_dim=32, num_heads=4, fusion_type="basic", classifier_type="mlp",
                         image_backbone="mamba_vision_export_pico", text_feature_dim=TINY_BERT.hidden_size,
                         bert=TINY_BERT)
    return init_parameters(MultimodalBaselineModel(cfg), torch.Generator().manual_seed(3)).eval()


def _connext_mamba_fusion():
    """ConNexT with the Mamba fusion: the artifact takes no hidden vectors, so it reads zeros."""
    register_convnext_variant("pico", (1, 1, 1, 1), (8, 8, 8, 16))
    cfg = dataclasses.replace(CONNEXT_HAM, convnext_variant="pico", use_mamba_fusion=True, llm_hidden_dim=24,
                              bert=TINY_BERT)
    return init_parameters(ConNexTClassifier(cfg), torch.Generator().manual_seed(4)).eval()


# name: (model maker, family, seq, TTA)
MODELS = {
    "mamba_vision_basic": (_mamba_vision_basic, "baseline", SEQ, ()),
    "connext_mamba_fusion": (_connext_mamba_fusion, "connext", SEQ, texport.TTA),
    "mibf_exact": (lambda: _mibf(TINY_BERT), "mibf", SEQ, ()),
    "mibf_int8": (lambda: _mibf(dataclasses.replace(TINY_BERT, fast_math=True, quantize="int8")), "mibf", SEQ, ()),
    "mibf_flash": (lambda: _mibf(dataclasses.replace(TINY_BERT, attention_impl="flash")), "mibf", 128, ()),
    "mamba_mlp": (lambda: _baseline("mamba", "mlp"), "baseline", SEQ, ()),
    "multiscale_moe": (lambda: _baseline("multiscale", "moe"), "baseline", SEQ, texport.TTA),
    "multiscale_kan": (lambda: _baseline("multiscale", "kan"), "baseline", SEQ, ()),  # base.yml's GroupKAN head
    "connext_moe": (_connext, "connext", SEQ, ()),
}


def _request(n, seq, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, seq), np.int64)
    mask[n // 2:, seq - 4:] = 0
    return {"image": rng.integers(0, 256, (n, CANVAS, CANVAS, 3), dtype=np.uint8),
            "input_ids": rng.integers(0, 128, (n, seq)).astype(np.int64), "attention_mask": mask}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each case's (live ServingModel, artifact path), exported once, when a test first asks."""
    made = {}

    def get(name):
        if name not in made:
            maker, family, seq, tta = MODELS[name]
            live = ServingModel(maker(), BATCH, "cpu", image_size=CROP, tta=tta)
            spec = texport.input_spec(BATCH, CANVAS, seq)
            path = str(tmp_path_factory.mktemp(name) / "model.pt2")
            texport.write_artifact(path, texport.export_program(live.fn, spec, CPU), live.fn, spec, CPU, family)
            made[name] = live, path
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loaded_artifact_serves_the_live_logits_bit_for_bit(served, name):
    live, path = served(name)
    art = ServingModel.load(path, "cpu")
    seq = MODELS[name][2]
    assert art.batch_size == BATCH and art.tta == live.tta and art.model is None
    assert (art.normalize, art.dtype) == (live.normalize, live.dtype)
    weights = dict(live.fn.named_parameters())  # channels_last convolution weights load back as they were
    assert {n: p.stride() for n, p in art.fn.named_parameters()} == {n: weights[n].stride() for n in weights}
    full = _request(BATCH, seq, seed=1)
    part = {k: v[:3] for k, v in _request(BATCH, seq, seed=2).items()}  # 3 rows of a batch of 4: padded
    for req in (full, part):
        got, want = art.predict(req), live.predict(req)
        assert got.shape == (req["image"].shape[0], LABELS) and got.dtype == np.float32
        assert np.isfinite(got).all() and np.array_equal(got, want), np.abs(got - want).max()


# --- (c) against the JAX package ------------------------------------------------------------------
@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            made[name] = Case(tmp_path_factory.mktemp(f"export_{name}"), *CLI_CASES[name])
        return made[name]

    return get


@pytest.fixture(scope="module")
def port_artifacts(cases):
    """Each case's port artifact (export_serving.main --device cpu --smoke_test of its msgpack,
    batch 4), the info it returns and what it printed, written once."""
    made = {}

    def get(name):
        if name not in made:
            case = cases(name)
            path = str(case.root / "model.pt2")
            with contextlib.redirect_stdout(io.StringIO()) as out:
                info = texport.main(case.argv("--output", path, "--family", case.family, "--batch_size", "4",
                                              "--device", "cpu", "--smoke_test"))
            made[name] = path, info, out.getvalue()
        return made[name]

    return get


def _jax_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((4, 16), np.int32)
    mask[2:, 11:] = 0
    return {"image": rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8),
            "input_ids": rng.integers(0, 100, (4, 16)).astype(np.int32), "attention_mask": mask}


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_port_artifact_matches_the_jax_artifact(cases, port_artifacts, name, tmp_path, monkeypatch):
    case = cases(name)
    jart = str(tmp_path / "model.jaxexport")
    case.jax_cli(monkeypatch, jexport, case.argv("--output", jart, "--family", case.family, "--batch_size", "4"))
    tart, info, printed = port_artifacts(name)
    assert json.loads(printed.strip().splitlines()[-1]) == info
    assert info["format"] == FORMAT and info["device"] == "cpu" and info["batch_size"] == 4
    assert info["inputs"] == {"image": [[4, 40, 40, 3], "uint8"], "input_ids": [[4, 16], "int64"],
                              "attention_mask": [[4, 16], "int64"]}
    assert info["bytes"] > info["weight_bytes"] > 0 and info["smoke_logits_shape"] == [4, 7] and info["smoke_finite"]
    batch = _jax_batch(0)
    want = np.asarray(jexport.load_and_run(jart, batch), np.float32)
    got = ServingModel.load(tart, "cpu").predict(batch)
    assert got.shape == want.shape == (4, 7)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # run_serve of both packages over the case's test split: the same CSV
    jcsv, tcsv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jserve.main(["--artifact", jart, "--config", case.cfg, "--output_path", jcsv, "--family", case.family])
    ids, preds = tserve.main(["--artifact", tart, "--config", case.cfg, "--output_path", tcsv, "--family",
                              case.family, "--device", "cpu"])
    assert len(ids) == len(preds) == 10 and _rows(tcsv) == _rows(jcsv) and len(_rows(tcsv)) == 11


def test_an_mibf_config_with_tabular_exports_the_jax_artifacts_tabular_input(cases, tmp_path, monkeypatch):
    """The tabular width comes from the metadata CSV for every family, as the JAX Trainer's predict-only
    construction takes it: an MIBF config with ``model.tabular`` on exports with JAX's ``tabular`` input,
    which MIBF-Net ignores in both packages; the logits within the CLI bound, the run_serve CSVs equal."""
    case = cases("mibf")
    sets = ("--set", "model.tabular.enabled=true")
    cfg = json.loads(Path(case.cfg).read_text())
    width = jtabular_map(cfg["data"]["metadata_csv"], ["age", "sex", "localization"])[1]
    monkeypatch.setattr(case.trainer, "_tabular_dim", width)  # what JAX's build_trainer(setup_data=False) gives
    jart, tart = str(tmp_path / "model.jaxexport"), str(tmp_path / "model.pt2")
    jinfo = case.jax_cli(monkeypatch, jexport, case.argv("--output", jart, "--family", "mibf", "--batch_size", "4",
                                                         *sets))
    info = texport.main(case.argv("--output", tart, "--family", "mibf", "--batch_size", "4", "--device", "cpu",
                                  *sets))
    assert width > 0 and info["inputs"]["tabular"] == jinfo["inputs"]["tabular"] == [[4, width], "float32"]
    batch = {**_jax_batch(0), "tabular": np.random.default_rng(1).standard_normal((4, width)).astype(np.float32)}
    loaded = ServingModel.load(tart, "cpu")
    got = loaded.predict(batch)
    np.testing.assert_allclose(got, np.asarray(jexport.load_and_run(jart, batch), np.float32), atol=ATOL, rtol=RTOL)
    assert np.array_equal(loaded.predict({**batch, "tabular": batch["tabular"] + 1.0}), got)
    jcsv, tcsv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jserve.main(["--artifact", jart, "--config", case.cfg, "--output_path", jcsv, "--family", "mibf", *sets])
    ids, _ = tserve.main(["--artifact", tart, "--config", case.cfg, "--output_path", tcsv, "--family", "mibf",
                          "--device", "cpu", *sets])
    assert len(ids) == 10 and _rows(tcsv) == _rows(jcsv)


# --- (d) the runtime around a loaded artifact --------------------------------------------------
@pytest.fixture(scope="module")
def artifact(served):
    live, path = served("multiscale_moe")
    return ServingModel.load(path, "cpu"), path


def test_stream_matches_sync_in_order(artifact):
    art, _ = artifact
    reqs = [_request(n, SEQ, seed=10 + i) for i, n in enumerate((4, 1, 3, 4, 2))]
    want = [art.predict(r) for r in reqs]
    for depth in (0, 1, 2, 5):
        got = list(art.predict_stream(iter(reqs), depth=depth))
        assert [g.shape[0] for g in got] == [4, 1, 3, 4, 2]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_partial_batch_rows_equal_the_full_batch_rows(artifact):
    art, _ = artifact
    full = _request(BATCH, SEQ, seed=3)
    part = {k: v[:2] for k, v in full.items()}
    got = art.predict(part)
    assert got.shape == (2, LABELS) and np.array_equal(got, art.predict(full)[:2])


def test_input_validation(artifact):
    art, _ = artifact
    req = _request(BATCH, SEQ, seed=4)
    with pytest.raises(KeyError, match="input_ids"):
        art.predict({k: v for k, v in req.items() if k != "input_ids"})
    with pytest.raises(ValueError, match="static batch is 4"):
        art.predict(_request(BATCH + 1, SEQ, seed=5))
    bad = dict(req, image=req["image"][:, :32])
    with pytest.raises(ValueError, match="expected"):
        art.predict(bad)
    bad = dict(req, input_ids=req["input_ids"][:, :5])  # the artifact's tokenizer length rules
    with pytest.raises(ValueError, match="expected"):
        art.predict(bad)


def test_format_tag_and_device_are_checked(artifact, tmp_path, monkeypatch):
    _, path = artifact
    meta = read_meta(path)
    assert meta["format"] == FORMAT and meta["device"] == "cpu" and meta["family"] == "baseline"
    assert meta["tta"] == list(texport.TTA) and meta["batch_size"] == BATCH
    other = tmp_path / "other.pt2"
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(other, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith("/extra/meta.json"):
                data = json.dumps({**meta, "format": "mdhs-serving-v2"}).encode()
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="unsupported serving artifact format 'mdhs-serving-v2'"):
        ServingModel.load(str(other), "cpu")
    (tmp_path / "plain.txt").write_text("not an archive")
    with pytest.raises(ValueError, match="not a serving artifact"):
        ServingModel.load(str(tmp_path / "plain.txt"), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ServingModel.load(path, "cuda")


def test_artifact_of_another_device_type_is_refused(artifact, monkeypatch):
    """With a card present, a CPU artifact is refused by its meta, as JAX's exported.platforms refuses one."""
    _, path = artifact
    monkeypatch.setattr("mdhs_tpu_torch.serving.resolve_device", lambda d: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="exported for 'cpu' and cannot run on 'cuda'"):
        ServingModel.load(path, "cuda")


# --- (e) no model code in the serving process -------------------------------------------------
def test_a_process_without_model_code_loads_and_serves_an_artifact(cases, port_artifacts, tmp_path):
    case = cases("mamba")
    art = port_artifacts("mamba")[0]
    want = tmp_path / "want.csv"
    tserve.main(["--artifact", art, "--config", case.cfg, "--output_path", str(want), "--family", "baseline",
                 "--device", "cpu"])
    script = textwrap.dedent(f"""
        import sys
        sys.modules["mdhs_tpu_torch.models"] = None  # importing model code now raises
        sys.modules["mdhs_tpu_torch.modules"] = None
        import numpy as np
        from mdhs_tpu_torch.cli import run_serve
        from mdhs_tpu_torch.serving import ServingModel
        model = ServingModel.load({art!r}, "cpu")
        rng = np.random.default_rng(0)
        out = model.predict(dict(image=rng.integers(0, 256, (3, 40, 40, 3), dtype=np.uint8),
                                 input_ids=rng.integers(0, 100, (3, 16)), attention_mask=np.ones((3, 16), np.int64)))
        assert out.shape == (3, 7) and np.isfinite(out).all()
        run_serve.main(["--artifact", {art!r}, "--config", {case.cfg!r}, "--output_path", {str(tmp_path / "got.csv")!r},
                        "--family", "baseline", "--device", "cpu"])
        print("LEAKED", sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "mdhs_tpu",
                                                                                "yaml", "msgpack")))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "2"  # as this process's two: the suite's other workers share the cores
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
    assert _rows(tmp_path / "got.csv") == _rows(want) and len(_rows(want)) == 11


# --- (f) the caches -------------------------------------------------------------------------------
def _constants(fn) -> dict:
    """Every tensor the loaded program holds that is not a parameter: buffers, and the
    constants the export lifted (plain tensor attributes of the module or its submodules)."""
    held = dict(fn.named_buffers())
    for prefix, mod in fn.named_modules():
        held.update({f"{prefix}.{k}".lstrip("."): v for k, v in vars(mod).items() if isinstance(v, torch.Tensor)})
    return held


def test_int8_weights_ride_in_the_artifact_as_constants(served):
    live, path = served("mibf_int8")
    art = ServingModel.load(path, "cpu")
    layer = live.model.text_encoder.bert.encoder.layer[0]
    kept = layer.int8_weights()
    held = [t for t in _constants(art.fn).values() if t.dtype == torch.int8]
    for w in (kept.wqkv, kept.wo, kept.w1, kept.w2):  # the layer's four int8 matrices, bit for bit
        assert any(h.shape == w.shape and torch.equal(h, w) for h in held)
    names = {n.target for n in art.fn.graph.nodes if n.op == "get_attr"}
    dense = [n for n in names if "encoder.layer.0" in n and n.endswith("dense.weight")
             or n.endswith(("query.weight", "key.weight", "value.weight"))]
    readers = [n for n in art.fn.graph.nodes if n.op == "get_attr" and n.target in dense and n.users]
    assert not readers, readers  # no request reads a float BERT matrix: nothing is quantized per request
    before = {n: (t.data_ptr(), t._version) for n, t in _constants(art.fn).items()}
    a = art.predict(_request(BATCH, SEQ, seed=6))
    b = art.predict(_request(BATCH, SEQ, seed=6))
    assert np.array_equal(a, b) and {n: (t.data_ptr(), t._version) for n, t in _constants(art.fn).items()} == before


def test_moe_bank_rides_in_the_artifact_as_constants(served):
    live, path = served("multiscale_moe")
    art = ServingModel.load(path, "cpu")
    kans = [n for n in art.fn.graph.nodes if n.target is torch.ops.mdhs.kan_forward.default]
    bank = live.model.classifier.moe.stacked_layers()
    assert len(kans) == len(bank)  # one call a layer of the bank, the TTA variants in one batch
    for node in kans:  # grids, base and scaled spline weights: kept tensors, not stacked per request
        assert all(a.op == "get_attr" for a in node.args[1:4]), [a.op for a in node.args[1:4]]
    for layer, node in zip(bank, kans):
        for kept, arg in zip(layer, node.args[1:4]):
            assert torch.equal(operator.attrgetter(arg.target)(art.fn), kept)
    before = {n: (t.data_ptr(), t._version) for n, t in _constants(art.fn).items()}
    art.predict(_request(BATCH, SEQ, seed=7))
    art.predict(_request(BATCH, SEQ, seed=8))
    assert {n: (t.data_ptr(), t._version) for n, t in _constants(art.fn).items()} == before


def _zeros(spec):
    return tuple(torch.zeros(shape, dtype=getattr(torch, dt)) for shape, dt in spec.values())


def test_export_keeps_no_traced_tensor_in_the_imagenet_statistics(monkeypatch):
    """An export traced with no eager forward before it (no int8 or MoE cache to need one):
    the statistics made inside the trace are not kept, and a later eager call gets real ones."""
    monkeypatch.setattr(preprocess, "_STATS", {})
    fn = ServingModel(_baseline("mamba", "mlp"), 2, "cpu", image_size=CROP).fn
    args = _zeros(texport.input_spec(2, CANVAS, SEQ))
    with torch.no_grad():
        torch.export.export(fn, args)
    assert preprocess._STATS == {}
    mean, std = preprocess.imagenet_stats(CPU)
    assert type(mean) is torch.Tensor and type(std) is torch.Tensor
    assert mean.tolist() == list(torch.tensor(preprocess.IMAGENET_MEAN).tolist())
    assert preprocess._STATS[CPU][0] is mean


def test_export_without_the_eager_forward_refuses_to_trace_a_cache():
    fn = ServingModel(_mibf(dataclasses.replace(TINY_BERT, fast_math=True, quantize="int8")), 2, "cpu",
                      image_size=CROP).fn
    args = _zeros(texport.input_spec(2, CANVAS, SEQ))
    with torch.no_grad(), pytest.raises(RuntimeError, match="run one eager forward"):
        torch.export.export(fn, args)
