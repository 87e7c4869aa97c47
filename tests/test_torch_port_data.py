"""The port's data path and config loader against the JAX package, on the CPU.

``mdhs_tpu_torch.core.config`` against ``mdhs_tpu.core.config`` on every YAML
under configs/ and its JSON form, and on override strings;
``data/tokenizer.py`` (Python and native) against ``mdhs_tpu.data.tokenizer``;
``data/png.py`` against PIL's decode; the canvas against ``_canvas_array``;
``data/datasets.py`` + ``data/loader.py`` against the JAX dataset and loader
on ``mdhs_tpu.data.synthetic``'s data, batch for batch; ``ops/tta.py``
against ``mdhs_tpu.ops.tta``; ``classification_report`` against
``mdhs_tpu.train.metrics``'s. Inputs are made from seeds with numpy.
"""

import json
import logging
import os
import struct
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mdhs_tpu.core import config as jconfig
from mdhs_tpu.data import datasets as jdata
from mdhs_tpu.data import loader as jloader
from mdhs_tpu.data import tokenizer as jtok
from mdhs_tpu.data.synthetic import generate_synthetic_dataset
from mdhs_tpu.ops import tta as jtta
from mdhs_tpu.train import metrics as jmetrics
from mdhs_tpu_torch import native
from mdhs_tpu_torch.core import config as tconfig
from mdhs_tpu_torch.data import datasets as tdata
from mdhs_tpu_torch.data import loader as tloader
from mdhs_tpu_torch.data import png
from mdhs_tpu_torch.data import tokenizer as ttok
from mdhs_tpu_torch.ops import tta as ttta
from mdhs_tpu_torch.train import metrics as tmetrics

REPO = Path(__file__).resolve().parent.parent
YAMLS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yml"))
RESOLVED = {"mibf_ham.json": "configs/mibf/mibf_ham.yml", "mibf_ham_serving.json": "configs/serving/mibf_ham_serving.yml",
            "ham_fusion_ssm_v1.json": "configs/ham/ham_fusion_ssm_v1.yml", "ham_base.json": "configs/common/base.yml",
            "ham_head_moe_v1.json": "configs/ham/ham_head_moe_v1.yml",
            "connext_ham.json": "configs/connext/connext_ham.yml"}


# --- config ----------------------------------------------------------------------------------
@pytest.mark.parametrize("path", YAMLS)
def test_load_config_matches_jax_on_the_yaml_and_its_json_form(path, tmp_path):
    want = jconfig.load_config(REPO / path).to_dict()
    assert tconfig.load_config(REPO / path).to_dict() == want
    tconfig.Config(want).save_json(tmp_path / "c.json")
    assert json.loads((tmp_path / "c.json").read_text()) == want
    assert tconfig.load_config(tmp_path / "c.json").to_dict() == want
    assert jconfig.load_config(tmp_path / "c.json").to_dict() == want  # yaml reads the JSON to the same dict


@pytest.mark.parametrize("name", sorted(RESOLVED))
def test_the_packaged_json_configs_are_their_yaml_resolved(name):
    """mdhs_tpu_torch/configs/*.json, for a machine with no yaml reader, hold the YAML as JAX resolves it."""
    assert tconfig.load_config(REPO / "mdhs_tpu_torch" / "configs" / name).to_dict() == \
        jconfig.load_config(REPO / RESOLVED[name]).to_dict()


def test_base_chain_and_overrides_match_jax(tmp_path):
    (tmp_path / "base.json").write_text(json.dumps({"a": {"b": 1, "c": [1, 2]}, "d": "x"}))
    (tmp_path / "mid.yml").write_text("_base_: base.json\na: {c: [3]}\ne: 2\n")
    (tmp_path / "top.json").write_text(json.dumps({"_base_": "mid.yml", "d": "y"}))
    overrides = ["a.b=7", "f.g=[hflip,vflip]", "d=null", "h=1e-4"]
    want = jconfig.load_config(tmp_path / "top.json", overrides=overrides).to_dict()
    assert tconfig.load_config(tmp_path / "top.json", overrides=overrides).to_dict() == want
    assert want == {"a": {"b": 7, "c": [3]}, "d": None, "e": 2, "f": {"g": ["hflip", "vflip"]}, "h": "1e-4"}


OVERRIDES = ["7", "-3", "1_000", "017", "0x1f", "0b101", "0.5", "1e-4", "2e-5", "1.0e-4", "-2.5E+3", ".5", ".inf",
             "-.Inf", "true", "False", "off", "Yes", "null", "~", "", "[1, 2.5, a]", "[]", "[hflip,vflip,rot90]",
             "[[1, 2], [3]]", "'quoted'", '"dq \\" x"', "abc", "/data/x.csv", "a b"]


@pytest.mark.parametrize("text", OVERRIDES)
def test_override_coercion_matches_jax(text):
    want = jconfig._coerce(text)
    assert tconfig._coerce(text) == want and type(tconfig._coerce(text)) is type(want)
    got = tconfig.parse_scalar(text)  # the reader where yaml does not import
    assert got == want and type(got) is type(want), (text, got, want)


def test_json_floats_read_as_floats_by_yaml():
    """PyYAML reads json.dumps(2e-05), "2e-05", as a string; save_json writes "2.0e-05"."""
    import yaml

    values = [2e-05, 1e-4, 1e20, 0.5, -3.0, 1.5e-7, 123456789.0, 1e16]
    assert [tconfig._json_float(v) for v in values[:3]] == ["2.0e-05", "0.0001", "1.0e+20"]
    text = tconfig.to_json({"a": values, "b": {"c": 2e-05, "d": [], "e": {}, "f": None, "g": True, "h": "x\"y"}})
    assert yaml.safe_load(text) == json.loads(text) == {"a": values, "b": {"c": 2e-05, "d": [], "e": {}, "f": None,
                                                                          "g": True, "h": "x\"y"}}


def test_override_nan_and_flow_mappings():
    assert np.isnan(tconfig.parse_scalar(".nan")) and np.isnan(jconfig._coerce(".NaN"))
    assert tconfig.parse_scalar("{a: 1}") == "{a: 1}"  # left a string, stated in its docstring


# --- tokenizer -------------------------------------------------------------------------------
TEXTS = ["The image shows a melanoma lesion.", "Hello, WORLD!!! unaffable", "café Café CAFÉ naïve résumé",
         "a,b..c!?d (irregular-border)", "中文斑 the 中 lesion", "皮肤镜 unknown 汉字", "x" * 150 + " hello", "", "   ",
         "  multiple   spaces\t\ttabs\nnewlines  hello ", "x xx xxx 1 12 122", "lesions lesion le unward",
         "hello \x00 world � again", "dermoscopy colorful skin " * 20, "Δ hello ΔΔ Москва",
         "5µg weiſſ", "café naïve", "hello world again"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "image", "shows", "a", "melanoma", "lesion", "##s", "le",
         "##sion", ",", ".", "!", "?", "-", "(", ")", "un", "##aff", "##able", "##ward", "hello", "world", "cafe",
         "naive", "resume", "border", "irregular", "x", "##x", "1", "##2", "12", "中", "文", "斑", "skin", "der",
         "##mo", "##scopy", "color", "##ful", "δ", "москва", "μg", "weiss", "5", "again"]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("max_length", [8, 32])
def test_synthetic_tokenizer_matches_jax(max_length):
    want, got = jtok.WordPieceTokenizer.synthetic(30522), ttok.WordPieceTokenizer.synthetic(30522)
    for text in TEXTS:
        for a, b in zip(want.encode(text, max_length), got.encode(text, max_length)):
            np.testing.assert_array_equal(a, b)
            assert b.dtype == np.int32
    assert ttok.basic_tokenize(TEXTS[2]) == jtok.basic_tokenize(TEXTS[2])


@pytest.mark.parametrize("max_length", [8, 32])
def test_vocab_file_tokenizers_match_jax_and_each_other(vocab_file, max_length):
    want = jtok.WordPieceTokenizer.from_vocab_file(vocab_file)
    python = ttok.WordPieceTokenizer.from_vocab_file(vocab_file)
    loaded = ttok.load_tokenizer(os.path.dirname(vocab_file))  # the directory holding vocab.txt
    assert isinstance(loaded, native.NativeWordPiece) and loaded.vocab_size == python.vocab_size == want.vocab_size
    for text in TEXTS:
        ref = want.encode(text, max_length)
        for tok in (python, loaded):
            for a, b in zip(ref, tok.encode(text, max_length)):
                np.testing.assert_array_equal(a, b)
    ids, mask = loaded.encode_batch(TEXTS, max_length)
    np.testing.assert_array_equal(ids, want.encode_batch(TEXTS, max_length)[0])
    assert ttok.load_tokenizer(None).vocab_size == 30522


# --- images ----------------------------------------------------------------------------------
def _png_rows(img: np.ndarray) -> tuple:
    """A PNG of ``img`` with row y filtered by filter y % 5 (all five), as a test-side encoder."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    raw = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        f, row = y % 5, raw[y]
        prev = raw[y - 1] if y else np.zeros_like(row)
        left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if f == 4:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = [np.zeros_like(row), left, prev, (left + prev) // 2][f]
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
    colour = {1: 0, 3: 2, 4: 6}[c]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(13, 17), (9, 11, 3), (12, 7, 4), (1, 1, 3)])
def test_png_reader_decodes_all_five_filters_as_pil(shape, tmp_path):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    data = _png_rows(img)
    (tmp_path / "f.png").write_bytes(data)
    np.testing.assert_array_equal(png.decode_png(data), img)
    with Image.open(tmp_path / "f.png") as pil:
        np.testing.assert_array_equal(png.decode_png(data), np.asarray(pil))


@pytest.mark.parametrize("mode, shape", [("L", (31, 45)), ("RGB", (40, 29, 3)), ("RGBA", (17, 23, 4))])
def test_png_reader_matches_pil_on_pil_pngs_and_pil_reads_the_port_png(mode, shape, tmp_path):
    rng = np.random.default_rng(len(mode))
    smooth = np.cumsum(rng.integers(0, 3, shape), axis=1).astype(np.uint8)  # PIL's adaptive filters differ by content
    for img in (rng.integers(0, 256, shape, dtype=np.uint8), smooth):
        Image.fromarray(img, mode).save(tmp_path / "pil.png")
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "pil.png")), img)
        png.write_png(str(tmp_path / "port.png"), img)
        with Image.open(tmp_path / "port.png") as pil:
            assert pil.mode == mode
            np.testing.assert_array_equal(np.asarray(pil), img)
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "port.png")), img)


def test_png_reader_refuses_what_it_does_not_read_naming_pil(tmp_path):
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "x.jpg")
    Image.fromarray(np.zeros((4, 4), np.uint16), "I;16").save(tmp_path / "x16.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(tmp_path / "p.png")
    for name in ("x.jpg", "x16.png", "p.png"):
        with pytest.raises(png.UnsupportedImage, match="Pillow"):
            png.read_png(str(tmp_path / name))


@pytest.mark.parametrize("shape", [(450, 600, 3), (600, 450, 3), (37, 29, 3), (256, 256, 3)])
def test_canvas_matches_jax_canvas_array(shape, monkeypatch):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    want = jdata._canvas_array(Image.fromarray(img), 64)
    calls = native.resize_center_square.calls
    np.testing.assert_array_equal(tdata.canvas_array(img, 64), want)
    assert native.resize_center_square.calls == calls + 1
    monkeypatch.setattr(native, "resize_center_square", lambda a, s: None)  # no library: PIL's resize
    np.testing.assert_array_equal(tdata.canvas_array(img, 64),
                                  np.asarray(jdata._resize_center_square(Image.fromarray(img), 64), np.uint8))


# --- dataset and loader ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_data")
    return generate_synthetic_dataset(str(root), num_images=11, image_size=48, num_classes=4)


def _pair(paths, csv=True, **opts):
    kw = dict(max_length=16, canvas=40, **opts)
    csv_path = paths["label_csv"] if csv else None
    return (jdata.MultimodalDataset(paths["image_dir"], paths["json_path"], csv_path,
                                    jtok.WordPieceTokenizer.synthetic(30522), jdata.DatasetOptions(**kw)),
            tdata.MultimodalDataset(paths["image_dir"], paths["json_path"], csv_path,
                                    ttok.WordPieceTokenizer.synthetic(30522), tdata.DatasetOptions(**kw)))


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if k == "image_id":
                assert x[k] == y[k]
            else:
                np.testing.assert_array_equal(x[k], y[k])
                assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k


@pytest.mark.parametrize("shuffle, weighted, clean", [(False, False, False), (True, False, True), (False, True, False)])
def test_dataset_and_loader_batches_match_jax(synth, shuffle, weighted, clean):
    jd, td = _pair(synth, clean_cjk_text=clean)
    assert jd.metadata == td.metadata and jd.labels == td.labels
    kw = dict(batch_size=4, shuffle=shuffle, weighted=weighted, num_classes=4, seed=3)
    _same_batches(jloader.DataLoader(jd, **kw), tloader.DataLoader(td, **kw))
    _same_batches(jloader.DataLoader(jd, prefetch=0, **kw), tloader.DataLoader(td, prefetch=0, **kw))
    batches = list(tloader.DataLoader(td, batch_size=4))
    assert [int(b["n_valid"]) for b in batches] == [4, 4, 3]
    assert batches[-1]["image_id"][3] == batches[-1]["image_id"][0]  # the tail padded by its first record


def test_unlabeled_dataset_and_clean_cjk_match_jax(synth, tmp_path):
    jd, td = _pair(synth, csv=False)
    assert jd.metadata == td.metadata and all(m["label"] == -1 for m in td.metadata)
    text = "病变 lesion　中文，irregular"
    assert tdata.clean_cjk(text) == jdata.clean_cjk(text)
    assert tdata.load_label_map(synth["label_csv"]) == jdata.load_label_map(synth["label_csv"])
    assert tdata.build_description_map(synth["json_path"]) == jdata.build_description_map(synth["json_path"])


def test_dataset_without_pil_reads_png_and_zeroes_what_it_cannot_read(synth, tmp_path, monkeypatch, caplog):
    """Where PIL does not import, PNGs go through data/png.py to the same canvases;
    a JPEG fails to load, becomes a zero canvas, and the warning names Pillow."""
    img_dir = tmp_path / "png"
    img_dir.mkdir()
    names = sorted(os.listdir(synth["image_dir"]))
    for name in names[:3]:
        with Image.open(os.path.join(synth["image_dir"], name)) as im:
            im.convert("RGB").save(img_dir / name.replace(".jpg", ".png"))
    (img_dir / "broken.jpg").write_bytes((Path(synth["image_dir"]) / names[3]).read_bytes())
    kw = dict(max_length=16, canvas=40)
    with_pil = tdata.MultimodalDataset(str(img_dir), None, None, ttok.WordPieceTokenizer.synthetic(), tdata.DatasetOptions(**kw))
    monkeypatch.setattr(tdata, "_pil", lambda: None)
    without = tdata.MultimodalDataset(str(img_dir), None, None, ttok.WordPieceTokenizer.synthetic(), tdata.DatasetOptions(**kw))
    decodes = png.decode_png.calls
    with caplog.at_level(logging.WARNING):
        recs = [without[i] for i in range(len(without))]
    assert png.decode_png.calls == decodes + 3
    broken = [r for r in recs if r["image_id"] == "broken.jpg"][0]
    assert not broken["image"].any() and "Pillow" in caplog.text
    for r, ref in zip(recs, [with_pil[i] for i in range(len(with_pil))]):
        if r["image_id"] != "broken.jpg":
            np.testing.assert_array_equal(r["image"], ref["image"])


@pytest.mark.parametrize("opt, item", [("llm_hidden_json", None), ("host_augment", "8")])
def test_unported_dataset_modes_raise_naming_their_item(synth, opt, item, tmp_path):
    """The host augmentation raises naming its item; the LLM hidden-state mode, once
    refused, gives every record JAX's ``first_hidden`` / ``last_hidden`` (a long
    vector truncated, a short one zero-padded, an image the JSON lacks zeros) and
    the loader stacks them."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
            tdata.MultimodalDataset(synth["image_dir"], synth["json_path"], synth["label_csv"],
                                    ttok.WordPieceTokenizer.synthetic(), tdata.DatasetOptions(**{opt: True}))
        return
    names = sorted(os.listdir(synth["image_dir"]))
    rng = np.random.default_rng(12)
    hidden = {f"llm/{n}": {"first_hidden_state": rng.standard_normal(6 + 4 * (i % 3)).tolist(),
                           "last_hidden_state": rng.standard_normal(9).tolist()} for i, n in enumerate(names[1:])}
    path = tmp_path / "hidden.json"
    path.write_text(json.dumps(hidden))
    jd, td = _pair(synth, llm_hidden_json=str(path), llm_hidden_dim=10)
    for i in range(len(td)):
        for k in ("first_hidden", "last_hidden"):
            assert td[i][k].shape == (10,) and td[i][k].dtype == np.float32
            np.testing.assert_array_equal(td[i][k], jd[i][k])
    first = [td[i] for i in range(len(td)) if td[i]["image_id"] == names[0]]
    assert not first or not first[0]["first_hidden"].any()
    batch = next(iter(tloader.DataLoader(td, batch_size=4, prefetch=0)))
    assert batch["first_hidden"].shape == (4, 10) and batch["last_hidden"].dtype == np.float32


# --- TTA -------------------------------------------------------------------------------------
@pytest.mark.parametrize("transforms", [("hflip",), ("hflip", "vflip", "rot90"), ("rot90", "vflip")])
def test_tta_matches_jax_after_the_layout_transpose(transforms):
    rng = np.random.default_rng(len(transforms))
    nhwc = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    nchw = torch.from_numpy(nhwc).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    want = np.asarray(jtta.tta_variants(jnp.asarray(nhwc), transforms))
    got = ttta.tta_variants(nchw, transforms).permute(0, 1, 3, 4, 2).numpy()
    np.testing.assert_array_equal(got, want)
    w = rng.standard_normal((8 * 8 * 3, 5)).astype(np.float32)
    ids = rng.integers(0, 9, (3, 4))

    def jfn(im, i):  # depends on the pixels' layout and on the tiled argument
        return im.reshape(im.shape[0], -1) @ w + i.sum(axis=1, keepdims=True)

    def tfn(im, i):
        return im.permute(0, 2, 3, 1).reshape(im.shape[0], -1) @ torch.from_numpy(w) + i.sum(dim=1, keepdim=True)

    ref = np.asarray(jtta.tta_logits(jfn, jnp.asarray(nhwc), jnp.asarray(ids), transforms=transforms))
    out = ttta.tta_logits(tfn, nchw, torch.from_numpy(ids), transforms=transforms).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)


# --- metrics ---------------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_classification_report_matches_jax(seed):
    """Class 4 never occurs in the labels, and the logits hold ties (scores rounded)."""
    rng = np.random.default_rng(seed)
    logits = np.round(rng.standard_normal((40, 5)), 1).astype(np.float32)
    labels = rng.integers(0, 4, 40).astype(np.int32)
    want = jmetrics.classification_report(jnp.asarray(logits), jnp.asarray(labels), 5)
    got = tmetrics.classification_report(torch.from_numpy(logits), torch.from_numpy(labels), 5)
    for key in ("accuracy", "accuracy_macro", "precision_macro", "recall_macro", "f1_macro", "auroc_macro"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-6, key
    for key in ("accuracy", "precision", "recall", "f1"):
        np.testing.assert_allclose(got["per_class"][key].numpy(), np.asarray(want["per_class"][key]), atol=1e-6)
    np.testing.assert_array_equal(got["confusion_matrix"].numpy(), np.asarray(want["confusion_matrix"]))
    probs = np.full((6, 3), 0.5, np.float32)  # every score tied
    lab = np.array([0, 1, 2, 0, 1, 0])
    assert abs(float(tmetrics.auroc_ovr_macro(torch.from_numpy(probs), torch.from_numpy(lab), 3))
               - float(jmetrics.auroc_ovr_macro(jnp.asarray(probs), jnp.asarray(lab), 3))) <= 1e-6
