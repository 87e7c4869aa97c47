"""The analysis surface of mdhs_tpu_torch against the JAX package's, on the CPU
in float32: Grad-CAM over the image tower's taps, the JET overlay, the
feature-rank spectrum and ``run_analysis``.

Grad-CAM: a baseline model of each case (ResNet18 with the ``concat``
fusion; ResNet18 with the ``multiscale`` fusion, the MoE head, through
``kan_forward``'s backward, and the global/local stream, whose two image
passes add the same zero tensors, so its gradient is the sum of theirs); the
JAX side is ``mdhs_tpu.analysis.gradcam.gradcam_device`` with zero
perturbations shaped by ``model.init``, as tests/test_analysis.py builds
them. The weights are the port's seeded init moved off its init values
(``jax_variables``: no JAX init compiles) in both packages. Both take one
``target_class`` and then each row's argmax; the port's argmax path is held
on the rows whose logit margin exceeds 1e-3. Bounds: max |d| <= 1e-4 on the
[0, 1] maps and <= 1e-4 x max |logit| on the logits. ``run_analysis`` runs
against the JAX CLI (its trainer's model not initialised, the checkpoint's
variables loaded whole) on one synthetic dataset and one JAX msgpack
checkpoint, with a tiny MambaVision tower: the returned spectra (singular
values within 1e-4 of the largest, the effective rank rtol 1e-4, rank@1 %
equal), the printed line, the image ids of the overlays written and the CAMs
each CLI draws (max |d| <= 1e-4).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_baseline import _perturb
from test_torch_port_mamba_vision import SPECS as MV_SPECS

from mdhs_tpu.analysis import feature_rank as jrank
from mdhs_tpu.analysis import gradcam as jcam
from mdhs_tpu.cli import run_analysis as jcli
from mdhs_tpu.core import checkpoint as jckpt
from mdhs_tpu.core.config import Config as JConfig
from mdhs_tpu.data.synthetic import generate_synthetic_dataset, synthetic_config
from mdhs_tpu.data.tokenizer import load_tokenizer
from mdhs_tpu.models import baseline as jbase
from mdhs_tpu.models import bert as jbert
from mdhs_tpu.models import mamba_vision as jmv
from mdhs_tpu.train.trainer import Trainer as JTrainer
from mdhs_tpu.train.trainer import build_model as jbuild_model
from mdhs_tpu_torch.analysis import feature_rank as trank
from mdhs_tpu_torch.analysis import gradcam as tcam
from mdhs_tpu_torch.cli import run_analysis as tcli
from mdhs_tpu_torch.core.config import Config
from mdhs_tpu_torch.core.convert import baseline_state_dict_from_jax
from mdhs_tpu_torch.data.png import read_png
from mdhs_tpu_torch.data.tokenizer import load_tokenizer as tload_tokenizer
from mdhs_tpu_torch.models import baseline as tbase
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import build_model as tbuild_model
from mdhs_tpu_torch.models import mamba_vision as tmv
from mdhs_tpu_torch.models.init import init_parameters

torch.set_num_threads(2)
BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
B, L = 3, 10
MAP_ATOL, LOGIT_FRAC = 1e-4, 1e-4
CASES = {  # fusion, head, backbone, image side, BaselineConfig extras
    "resnet18_concat": ("concat", "mlp", "resnet18", 32, {}),
    "resnet18_multiscale_moe_global_local": ("multiscale", "moe", "resnet18", 32, dict(global_local_enabled=True)),
}


@pytest.fixture(scope="module", autouse=True)
def tiny_zoo():
    with pytest.MonkeyPatch.context() as mp:
        for name, spec in MV_SPECS.items():
            mp.setitem(jmv.MAMBA_VISION_SPECS, name, spec)
            mp.setitem(tmv.MAMBA_VISION_SPECS, name, spec)
        yield


def _cfg(module, fusion, head, backbone, **extra):
    return module.BaselineConfig(num_classes=7, hidden_dim=32, text_feature_dim=32, num_heads=4, dropout=0.0,
                                 image_backbone=backbone, fusion_type=fusion, classifier_type=head,
                                 bert=(jbert if module is jbase else tbert).BertConfig(**BERT), **extra)


def _inputs(seed, side):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, side, side, 3)).astype(np.float32)  # NHWC, the JAX layout
    ids = rng.integers(0, 128, (B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[0, 6:] = 0
    return img, ids, mask


def _jax_args(img, ids, mask):
    return jnp.asarray(img), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)


def _torch_args(img, ids, mask):
    return (torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))), torch.from_numpy(ids),
            torch.from_numpy(mask))


def jax_variables(jmodel, args, model, fusion, head, seed=0, taps=False):
    """The JAX model's variables holding ``model``'s seeded init (``init_parameters``, the
    JAX init's semantics), each leaf then moved off its init value (``_perturb``), without
    compiling the JAX init: the trees' structure comes from ``jax.eval_shape``, and each
    leaf is filled through ``baseline_state_dict_from_jax`` run on trees of unique codes,
    which tell where each of the port tensors' entries sits. With ``taps``, the structure
    is ``logits_and_taps``' and zero perturbations are added."""
    method = jmodel.logits_and_taps if taps else None
    shapes = jax.eval_shape(lambda r: jmodel.init({"params": r}, *args, method=method), jax.random.PRNGKey(0))
    trees = {k: shapes[k] for k in ("params", "batch_stats", "kan_state") if k in shapes}
    leaves, treedef = jax.tree_util.tree_flatten(trees)
    starts = np.cumsum([0] + [int(np.prod(a.shape)) for a in leaves])
    coded = treedef.unflatten([np.arange(s, e, dtype=np.float64).reshape(a.shape)
                               for s, e, a in zip(starts, starts[1:], leaves)])
    names = baseline_state_dict_from_jax(coded["params"], coded["batch_stats"], coded.get("kan_state"), fusion, head)
    values = init_parameters(model, torch.Generator().manual_seed(seed)).state_dict()
    flat = np.full(starts[-1], np.nan)
    for name, code in names.items():
        flat[code.numpy().astype(np.int64).ravel()] = values[name].double().numpy().ravel()
    assert not np.isnan(flat).any()
    filled = treedef.unflatten([flat[s:e].reshape(a.shape).astype(np.float32)
                                for s, e, a in zip(starts, starts[1:], leaves)])
    var = {k: _perturb(v, seed=i) for i, (k, v) in enumerate(filled.items())}
    if taps:
        var["perturbations"] = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, jnp.float32),
                                                      shapes["perturbations"])
    return var


@functools.lru_cache(maxsize=None)
def pair(case):
    """(the JAX Grad-CAM of the case's JAX model on the seed-1 inputs, compiled once: with target class 3
    and at each row's argmax; the port's model with the same weights; its image side)."""
    fusion, head, backbone, side, extra = CASES[case]
    jmodel = jbase.MultimodalBaselineModel(_cfg(jbase, fusion, head, backbone, **extra), dtype=jnp.float32)
    model = tbase.MultimodalBaselineModel(_cfg(tbase, fusion, head, backbone, **extra)).eval()
    args = _jax_args(*_inputs(1, side))
    var = jax_variables(jmodel, args, model, fusion, head, taps=True)
    model.load_state_dict(baseline_state_dict_from_jax(var["params"], var["batch_stats"], var.get("kan_state"),
                                                       fusion, head), strict=True)
    fwd = lambda v: jmodel.apply(v, *args, method=jmodel.logits_and_taps)  # noqa: E731
    cam = jax.jit(lambda v, t: jcam.gradcam_device(fwd, v, target_class=t, image_size=side, return_layer_cams=True))
    fixed = jax.tree_util.tree_map(np.asarray, cam(var, jnp.full((B,), 3)))
    # the argmax path: one-hot at each row's argmax, as gradcam_device makes it where no target is given
    at_argmax = jax.tree_util.tree_map(np.asarray, cam(var, jnp.argmax(fixed[1], axis=-1)))
    return (fixed, at_argmax), model, side


def _ours(case, target_class):
    _, model, side = pair(case)
    targs = _torch_args(*_inputs(1, side))
    return tcam.gradcam(lambda p: model.logits_and_taps(*targs, perturbations=p), target_class=target_class,
                        image_size=side, return_layer_cams=True)


def _close_maps(got, want):
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    assert float(np.abs(got - np.asarray(want)).max()) <= MAP_ATOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradcam_matches_jax(case):
    """One target class for both: the logits, the averaged CAM and each layer's."""
    (jwant, _), _, _ = pair(case)
    javg, jlogits, jlayers = jwant
    avg, logits, layers = _ours(case, 3)
    assert logits.shape == (B, 7)
    assert float(np.abs(logits - jlogits).max()) <= LOGIT_FRAC * float(np.abs(jlogits).max())
    assert set(layers) == set(jlayers) == set(tcam.DEFAULT_LAYERS)
    _close_maps(avg, javg)
    assert float(avg.max()) == 1.0 and float(avg.min()) >= 0.0
    for name in layers:
        _close_maps(layers[name], jlayers[name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradcam_argmax_matches_jax_away_from_ties(case):
    """No target: each row's argmax, held on the rows whose top-2 logit margin exceeds 1e-3."""
    (_, (javg, jlogits, _)), _, _ = pair(case)
    avg, logits, _ = _ours(case, None)
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    rows = np.flatnonzero(top2[:, 1] - top2[:, 0] > 1e-3)
    assert rows.size >= 2
    np.testing.assert_array_equal(logits[rows].argmax(-1), jlogits[rows].argmax(-1))
    _close_maps(avg[rows], javg[rows])


GL_CASE = "resnet18_multiscale_moe_global_local"


def test_gradcam_sums_both_global_local_passes():
    """The two passes add the same tensors: the gradient is their sum, not the first pass's alone."""
    _, model, side = pair(GL_CASE)
    img, ids, mask = _torch_args(*_inputs(3, side))
    perts = {}
    logits, taps = model.logits_and_taps(img, ids, mask, perturbations=perts)
    g_sum, g_first = torch.autograd.grad(logits[:, 2].sum(), [perts["layer4"], taps["layer4"]])
    assert not torch.allclose(g_sum, g_first, atol=1e-6)


def test_served_forward_without_perturbations_adds_no_op():
    """perturbations=None: the served logits bit for bit those of zero perturbations, and
    the tower runs no add at its taps (five fewer adds a pass than with them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Adds(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func.overloadpacket is torch.ops.aten.add
            return func(*args, **(kwargs or {}))

    _, model, side = pair(GL_CASE)
    args = _torch_args(*_inputs(4, side))
    counts = []
    for perts in (None, {}):
        with torch.no_grad(), Adds() as mode:
            model.image_encoder(args[0], perts)
        counts.append(mode.n)
    assert counts[1] - counts[0] == len(tcam.DEFAULT_LAYERS)
    with torch.no_grad():
        served = model(*args)
        zero, taps = model.logits_and_taps(*args, perturbations={})
    assert torch.equal(served, zero) and taps["layer4"].shape == (B, 512, 1, 1)


def test_a_sequence_input_has_no_cam_layers_as_in_jax():
    """A 5-D sequence input has no taps in either package: both raise "no CAM layers found"."""
    cfg = dict(sequence_enabled=True, sequence_hidden_dim=32)
    jmodel = jbase.MultimodalBaselineModel(_cfg(jbase, "concat", "mlp", "resnet18", **cfg), dtype=jnp.float32)
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)
    ids, mask = rng.integers(0, 128, (2, L)).astype(np.int64), np.ones((2, L), np.int64)
    jargs = (jnp.asarray(img), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    shapes = jax.eval_shape(functools.partial(jmodel.init, method=jmodel.logits_and_taps), jax.random.PRNGKey(0),
                            *jargs)
    fwd = lambda v: jmodel.apply(v, *jargs, method=jmodel.logits_and_taps)  # noqa: E731
    with pytest.raises(ValueError, match="no CAM layers found"):  # raised while tracing: nothing compiles
        jax.eval_shape(lambda v: jcam.gradcam_device(fwd, v, image_size=32), shapes)
    model = tbase.MultimodalBaselineModel(_cfg(tbase, "concat", "mlp", "resnet18", **cfg)).eval()
    timg = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 1, 4, 2, 3)))
    with pytest.raises(ValueError, match="no CAM layers found"):
        tcam.gradcam(lambda p: model.logits_and_taps(timg, torch.from_numpy(ids), torch.from_numpy(mask),
                                                     perturbations=p), image_size=32)


# --------------------------------------------------------------------------- the overlay and the spectrum
def test_jet_table_is_opencvs():
    cv2 = pytest.importorskip("cv2")
    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[..., ::-1][:, 0]
    assert tcam.JET.dtype == np.uint8 and np.array_equal(tcam.JET, want)


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_visualize_cam_matches_jax(alpha):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(6)
    img = rng.uniform(-0.1, 1.1, (40, 48, 3)).astype(np.float32)
    cam = rng.uniform(0, 1, (40, 48)).astype(np.float32)
    cam[0, :4] = [0.0, 1.0, 0.5, 127.5 / 255]
    got = tcam.visualize_cam(img, cam, alpha)
    assert got.dtype == np.uint8 and np.array_equal(got, jcam.visualize_cam(img, cam, alpha))


def test_visualize_cam_of_another_size_raises():
    with pytest.raises(ValueError, match="must agree"):
        tcam.visualize_cam(np.zeros((8, 8, 3), np.float32), np.zeros((4, 4), np.float32))


def test_feature_rank_matches_jax():
    rng = np.random.default_rng(7)
    chunks = [rng.normal(size=(n, 24)).astype(np.float32) @ rng.normal(size=(24, 24)).astype(np.float32) * 0.3
              for n in (16, 9)]
    chunks[1][:, :6] = 0.0
    ours, theirs = trank.FeatureRankAnalyzer(), jrank.FeatureRankAnalyzer()
    for c in chunks:
        ours.add(torch.from_numpy(c))
        theirs.add(c)
    got, want = ours.compute(), theirs.compute()
    np.testing.assert_allclose(got["singular_values"], want["singular_values"], rtol=1e-5)
    np.testing.assert_allclose(got["normalized"], want["normalized"], rtol=1e-5)
    assert got["effective_rank"] == want["effective_rank"] and got["rank_at_1pct"] == want["rank_at_1pct"]
    with pytest.raises(ValueError, match="no features"):
        trank.FeatureRankAnalyzer().compute()


# --------------------------------------------------------------------------- run_analysis
class _EvalTrainer(JTrainer):
    """The JAX Trainer as the JAX CLI uses it (its ``make_test_loader``, ``_preprocess_eval``,
    ``model``, ``variables``), with the model built but not initialised (its init compiles for
    tens of seconds on the CPU); ``load_weights`` takes a msgpack checkpoint's trees whole."""

    def __init__(self, cfg):
        self.cfg, self.family = cfg, "baseline"
        self.image_size, self.canvas, self.normalize = int(cfg.get("data.image_size")), int(cfg.get("data.canvas")), True
        self.tokenizer = load_tokenizer(cfg.get("model.text_encoder.model_name"))
        self.model = jbuild_model(cfg, "baseline", self.tokenizer)
        self._variables = None

    def load_weights(self, path):
        self._variables = {k: v for k, v in jckpt.load_checkpoint(path).items() if v}

    def variables(self, params=None, train=False):
        return self._variables


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """mdhs_tpu.data.synthetic's dataset (10 images, 4 a batch: the last 2 rows, padded) and config
    (tiny BERT, float32, canvas 40 / crop 32) with the tiny MambaVision tower, as JSON; a JAX
    msgpack checkpoint of seeded weights (``jax_variables``) and the JAX CLI's trainer."""
    root = tmp_path_factory.mktemp("analysis_cli")
    paths = generate_synthetic_dataset(str(root), num_images=10, image_size=48)
    cfg = synthetic_config(paths, str(root), batch_size=4, num_epochs=1, max_length=16)
    cfg["data"].update(canvas=40, image_size=32)
    cfg["model"]["image_encoder"]["backbone"] = "mamba_vision_TINY"
    path = str(root / "config.json")
    Config(cfg).save_json(path)
    trainer = _EvalTrainer(JConfig(cfg))
    model = tbuild_model(Config(cfg), "baseline", tload_tokenizer(None), device="cpu")
    args = (jnp.zeros((4, 32, 32, 3)), jnp.zeros((4, 16), jnp.int32), jnp.ones((4, 16), jnp.int32))
    var = jax_variables(trainer.model, args, model, "concat", "mlp", seed=7, taps=True)
    ckpt = str(root / "weights.msgpack")
    jckpt.save_checkpoint(ckpt, {k: v for k, v in var.items() if k != "perturbations"})
    return path, ckpt, trainer


def test_run_analysis_matches_the_jax_cli(cli_case, tmp_path, monkeypatch, capsys):
    """Both CLIs over the same checkpoint and test split, 9 CAMs (the padded batch's first row
    included): the spectra, the printed line, the image ids of the overlays, and the CAMs each
    CLI draws (max |d| <= 1e-4); the port's overlays read back as (32, 32, 3) uint8 PNGs."""
    cfg, ckpt, trainer = cli_case
    monkeypatch.setattr(jcli, "build_trainer", lambda *a, **k: trainer)
    cams = {}
    for name, module in (("jax", jcli), ("port", tcli)):
        real, cams[name] = module.visualize_cam, []
        monkeypatch.setattr(module, "visualize_cam",
                            lambda img, cam, *a, store=cams[name], real=real: store.append(cam) or real(img, cam, *a))
    argv = ["--config", cfg, "--model_path", ckpt, "--num_cam_images", "9"]
    want = jcli.main(argv + ["--output_dir", str(tmp_path / "jax")])
    jax_line = capsys.readouterr().out.splitlines()[-1]
    got = tcli.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == jax_line and jax_line.endswith("CAMs written: 9")
    s = want["singular_values"]
    assert got["singular_values"].shape == s.shape == (10,)
    assert float(np.abs(got["singular_values"] - s).max()) <= 1e-4 * float(s.max())
    assert abs(got["effective_rank"] - want["effective_rank"]) <= 1e-4 * want["effective_rank"]
    assert got["rank_at_1pct"] == want["rank_at_1pct"]
    written = {n: sorted(os.path.splitext(f)[0] for f in os.listdir(tmp_path / n) if f.startswith("cam_"))
               for n in ("jax", "port")}
    assert written["port"] == written["jax"] and len(written["port"]) == 9
    assert len(cams["port"]) == len(cams["jax"]) == 9
    _close_maps(np.stack(cams["port"]), np.stack(cams["jax"]))
    png = read_png(str(tmp_path / "port" / f"{written['port'][0]}.png"))
    assert png.shape == (32, 32, 3) and png.dtype == np.uint8
