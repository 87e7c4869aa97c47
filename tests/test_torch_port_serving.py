"""mdhs_tpu_torch.serving.ServingModel and the package's import hygiene, on the CPU.

The models are the full MIBF-Net graph, and the baseline family's two served
configurations (mamba + mlp, multiscale + moe), cut to one narrow BERT layer
and a 64^2 crop, with weights drawn from a seeded torch.Generator.
"""

import copy
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from mdhs_tpu_torch import resolve_device
from mdhs_tpu_torch.models.baseline import BaselineConfig, MultimodalBaselineModel
from mdhs_tpu_torch.models.bert import BertConfig
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.models.mibf import MIBFNet
from mdhs_tpu_torch.ops.preprocess import eval_pipeline
from mdhs_tpu_torch.serving import ServingModel

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CANVAS, CROP, SEQ, LABELS, BATCH = 72, 64, 12, 7, 4
TINY_BERT = BertConfig(vocab_size=128, num_hidden_layers=1, intermediate_size=128,
                       max_position_embeddings=64)


@pytest.fixture(scope="module")
def model():
    return init_parameters(MIBFNet(LABELS, TINY_BERT), torch.Generator().manual_seed(0)).eval()


def _request(n, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, SEQ), np.int64)
    mask[n // 2:, SEQ - 4:] = 0
    return {
        "image": rng.integers(0, 256, (n, CANVAS, CANVAS, 3), dtype=np.uint8),
        "input_ids": rng.integers(0, 128, (n, SEQ)).astype(np.int64),
        "attention_mask": mask,
    }


def _direct(model, req, normalize=False):
    with torch.no_grad():
        img = eval_pipeline(torch.from_numpy(req["image"]), CROP, normalize=normalize, dtype=torch.float32)
        out = model(img, torch.from_numpy(req["input_ids"]), torch.from_numpy(req["attention_mask"]))
    return (out["image_text"] if isinstance(out, dict) else out).numpy()


@pytest.mark.parametrize("n", [1, 3, BATCH])
def test_predict_pads_partial_batches_and_matches_a_direct_forward(model, n):
    server = ServingModel(model, BATCH, "cpu", image_size=CROP)
    req = _request(n, seed=n)
    out = server.predict(req)
    assert out.shape == (n, LABELS) and out.dtype == np.float32
    np.testing.assert_allclose(out, _direct(model, req), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_predict_stream_keeps_request_order(model, depth):
    server = ServingModel(model, BATCH, "cpu", image_size=CROP)
    reqs = [_request(n, seed=10 + i) for i, n in enumerate((4, 1, 3, 4, 2))]
    outs = list(server.predict_stream(iter(reqs), depth=depth))
    assert [o.shape[0] for o in outs] == [4, 1, 3, 4, 2]
    for req, out in zip(reqs, outs):
        np.testing.assert_allclose(out, _direct(model, req), atol=1e-5, rtol=1e-5)


def test_padding_rows_do_not_leak_into_real_rows(model):
    server = ServingModel(model, BATCH, "cpu", image_size=CROP)
    full = _request(BATCH, seed=3)
    part = {k: v[:2] for k, v in full.items()}
    np.testing.assert_allclose(server.predict(part), server.predict(full)[:2], atol=1e-5, rtol=1e-5)


def test_serving_rejects_bad_requests(model):
    server = ServingModel(model, BATCH, "cpu", image_size=CROP)
    with pytest.raises(ValueError, match="static batch"):
        server.predict(_request(BATCH + 1, seed=0))
    bad = _request(2, seed=0)
    del bad["attention_mask"]
    with pytest.raises(KeyError):
        server.predict(bad)
    with pytest.raises(ValueError, match="batch_size"):
        ServingModel(model, 0, "cpu")


def _baseline(fusion, head, dtype=None):
    cfg = BaselineConfig(hidden_dim=32, num_heads=4, fusion_type=fusion, classifier_type=head,
                         text_feature_dim=TINY_BERT.hidden_size, bert=TINY_BERT)
    return init_parameters(MultimodalBaselineModel(cfg, dtype=dtype), torch.Generator().manual_seed(1)).eval()


@pytest.mark.parametrize("fusion, head", [("mamba", "mlp"), ("multiscale", "moe")])
def test_serving_the_baseline_normalizes_and_returns_its_logits(fusion, head):
    model = _baseline(fusion, head)
    server = ServingModel(model, BATCH, "cpu", image_size=CROP)
    assert server.normalize and server.dtype == torch.float32
    reqs = [_request(n, seed=20 + n) for n in (BATCH, 2)]
    for req, out in zip(reqs, server.predict_stream(iter(reqs), depth=1)):
        assert out.shape == (req["image"].shape[0], LABELS) and out.dtype == np.float32
        np.testing.assert_allclose(out, _direct(model, req, normalize=True), atol=1e-5, rtol=1e-5)
        assert not np.allclose(out, _direct(model, req, normalize=False), atol=1e-3)


def test_serving_takes_the_image_towers_dtype():
    """A bf16 baseline holds float32 parameters (KAN, MoE gate, Mamba's dt_bias,
    A_log, D); the served images are bf16 all the same."""
    model = _baseline("mamba", "moe", dtype=torch.bfloat16)
    assert any(p.dtype == torch.float32 for p in model.parameters())
    server = ServingModel(model, 2, "cpu", image_size=CROP)
    assert server.dtype == torch.bfloat16 and server.normalize
    mibf = ServingModel(MIBFNet(LABELS, TINY_BERT, dtype=torch.bfloat16), 2, "cpu", image_size=CROP)
    assert mibf.dtype == torch.bfloat16 and not mibf.normalize


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_serving_runs_on_the_card_unless_asked_for_the_cpu(model):
    if torch.cuda.is_available():
        assert ServingModel(copy.deepcopy(model), 1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ServingModel(model, 1)


def test_package_imports_no_jax_and_runs_the_slice():
    """A fresh interpreter: the port's modules, a CPU run of the serving slice,
    a training step, a forward of each served baseline configuration, a
    served ConNexT, a BERT forward under attention_impl="flash" and run_predict
    over PNGs with a JSON config and a port checkpoint leave jax, flax and
    mdhs_tpu out of sys.modules (this test process has them, because the
    suite's conftest imports jax), and the CLI run imports neither yaml nor
    msgpack, which the card's machine does not have."""
    script = textwrap.dedent(f"""
        import dataclasses, sys
        import numpy as np, torch
        import mdhs_tpu_torch
        from mdhs_tpu_torch.core import convert
        from mdhs_tpu_torch.models import baseline, bert, connext, convnext, encoders, init, mibf, resnet
        from mdhs_tpu_torch.modules import attention, fusion, heads, kan, mamba, moe
        from mdhs_tpu_torch.models import norm
        from mdhs_tpu_torch.ops import (_build, attention_block, augment, bn_stats, ffn_block, flash_attention,
                                        fused_attention, gelu, kan_spline, preprocess, quant, quant_kernel,
                                        selective_scan, shear)
        from mdhs_tpu_torch.presets import CONNEXT_HAM, HAM_FUSION_SSM, HAM_HEAD_MOE, MIBF_HAM_SERVING
        from mdhs_tpu_torch.serving import ServingModel
        from mdhs_tpu_torch.train import losses, metrics, optim, trainer
        from mdhs_tpu_torch import native
        from mdhs_tpu_torch.core import checkpoint, config, dtypes
        from mdhs_tpu_torch.data import datasets, loader, png, tokenizer
        from mdhs_tpu_torch.ops import tta
        from mdhs_tpu_torch.cli import common, export_serving, run_ablation_eval, run_evaluate, run_predict, run_serve
        from mdhs_tpu_torch.ops import _library
        from mdhs_tpu_torch.models import build_model
        cfg = bert.BertConfig(vocab_size=64, num_hidden_layers=1, intermediate_size=64,
                              max_position_embeddings=16)
        m = init.init_parameters(mibf.MIBFNet(3, cfg), torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        req = dict(image=rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8),
                   input_ids=rng.integers(0, 64, (2, 8)), attention_mask=np.ones((2, 8), np.int64))
        out = ServingModel(m, 2, "cpu", image_size=32).predict(req)
        assert out.shape == (2, 3) and np.isfinite(out).all()
        q = mibf.MIBFNet(3, dataclasses.replace(cfg, fast_math=True, quantize="int8"))
        q.load_state_dict(m.state_dict())
        out = ServingModel(q, 2, "cpu", image_size=32).predict(req)
        assert out.shape == (2, 3) and np.isfinite(out).all()
        preset = dataclasses.replace(trainer.MIBF_HAM_TRAIN, bert=cfg, num_labels=3, batch_size=2, seq_len=8,
                                     canvas=40, image_size=32)
        step = trainer.Trainer(preset, model=m, device="cpu").train_step(
            dict(req, label=np.array([0, 2]), n_valid=np.int32(1)))
        assert np.isfinite(float(step["loss"]))
        for preset in (HAM_FUSION_SSM, HAM_HEAD_MOE):
            b = init.init_parameters(baseline.MultimodalBaselineModel(dataclasses.replace(
                preset, hidden_dim=32, num_heads=4, text_feature_dim=768, bert=cfg)), torch.Generator().manual_seed(0))
            out = ServingModel(b, 2, "cpu", image_size=32).predict(req)
            assert out.shape == (2, 7) and np.isfinite(out).all()
        convnext.register_convnext_variant("pico", (1, 1, 1, 1), (8, 8, 8, 16))
        c = init.init_parameters(connext.ConNexTClassifier(dataclasses.replace(
            CONNEXT_HAM, convnext_variant="pico", moe_expert_layers=(768, 16, 7), bert=cfg)),
            torch.Generator().manual_seed(0))
        out = ServingModel(c, 2, "cpu", image_size=32).predict(req)
        assert out.shape == (2, 7) and np.isfinite(out).all()
        flash = bert.BertModel(dataclasses.replace(cfg, max_position_embeddings=128, attention_impl="flash"))
        mask = np.ones((2, 128), np.int64)
        mask[1, 50:] = 0
        with torch.no_grad():
            last = flash(torch.from_numpy(rng.integers(0, 64, (2, 128))), torch.from_numpy(mask))[0]
        assert last.shape == (2, 128, 768) and torch.isfinite(last).all()
        import json, pathlib, tempfile
        root = pathlib.Path(tempfile.mkdtemp())
        (root / "img").mkdir()
        for i in range(3):
            png.write_png(str(root / "img" / f"{{i}}.png"), rng.integers(0, 256, (30 + i, 40, 3), dtype=np.uint8))
        (root / "d.json").write_text(json.dumps([{{"image_info": f"{{i}}.png", "description": "a lesion"}} for i in range(3)]))
        (root / "l.csv").write_text("image_id,label\\n0.png,1\\n1.png,0\\n2.png,2\\n")
        conf = config.Config({{"data": {{"test_image_dir": str(root / "img"), "test_json_path": str(root / "d.json"),
                                       "test_label_csv": str(root / "l.csv"), "canvas": 40, "image_size": 32}},
                              "model": {{"num_classes": 3, "text_encoder": {{"preset": "tiny"}}}},
                              "training": {{"batch_size": 2, "precision": "fp32"}}, "tokenizer": {{"max_length": 8}}}})
        conf.save_json(root / "c.json")
        checkpoint.save_checkpoint(str(root / "w.pt"), build_model(conf, "mibf", tokenizer.load_tokenizer(None)))
        out = run_predict.main(["--config", str(root / "c.json"), "--model_path", str(root / "w.pt"), "--family",
                                "mibf", "--output_path", str(root / "s.csv"), "--device", "cpu"])
        assert out["logits"].shape == (3, 3) and np.isfinite(out["logits"]).all()
        print("CARD_ABSENT", sorted(k for k in sys.modules if k.split(".")[0] in ("yaml", "msgpack")))
        bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "mdhs_tpu"))
        print("LEAKED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "2"  # as this process's two: the suite's other workers share the cores
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
    assert "CARD_ABSENT []" in proc.stdout, proc.stdout  # a JSON config and a port checkpoint need neither
