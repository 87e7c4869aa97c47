"""The dataset's stacked modes, the tabular map and the Spine / HAM branch
configurations of mdhs_tpu_torch against the JAX package, on the CPU.

A seeded directory of numbered slices (RGB, RGBA and gray PNGs, written by
``data/png.py``) with gaps, so that a neighbour is found under the
reference-intent name, under the zero-padded one, or not at all (the centre
slice); a corrupt file and a missing centre. Each mode's uint8 stack
(sequence, multi-view, pseudo-2.5D) equals the JAX dataset's bit for bit,
with PIL and without it (``data/png.py`` and ``datasets.py::luma``), the
loader's 5-D batches and float32 ``tabular`` column too. ``build_tabular_map``
(no pandas) equals the JAX package's pandas version bit for bit on metadata
CSVs with missing ages, NA strings, ``unknown`` and unseen categories,
booleans, a single-valued and an all-NA numeric column, a field the CSV
lacks, and ``normalize`` off. The resolved JSON configurations equal
``load_config`` of their YAML.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mdhs_tpu.core import config as jconfig
from mdhs_tpu.data import datasets as jdata
from mdhs_tpu.data import loader as jloader
from mdhs_tpu.data import tokenizer as jtok
from mdhs_tpu_torch.core import config as tconfig
from mdhs_tpu_torch.data import datasets as tdata
from mdhs_tpu_torch.data import loader as tloader
from mdhs_tpu_torch.data import png
from mdhs_tpu_torch.data import tokenizer as ttok

REPO = Path(__file__).resolve().parent.parent
CANVAS = 40
# every slice on disk: (file name, mode); the gaps are pA 008, pA 011, pB 3, pD 000
SLICES = [("pA_slice_005.png", "RGB"), ("pA_slice_6.png", "RGBA"), ("pA_slice_006.png", "L"),
          ("pA_slice_007.png", "RGB"), ("pA_slice_009.png", "L"), ("pA_slice_010.png", "RGBA"),
          ("pA_slice_012.png", "RGB"), ("pB1.png", "L"), ("pB2.png", "RGB"), ("pB4.png", "RGBA"),
          ("scan.png", "RGB"), ("pD_slice_001.png", "RGB"), ("pD_slice_002.png", "L")]
CENTRES = ["pA_slice_007.png", "pA_slice_010.png", "pB2.png", "scan.png", "pD_slice_001.png", "pC_slice_003.png",
           "pA_slice_009.png", "missing_004.png"]
METADATA = """lesion_id,image_id,dx,dx_type,age,sex,localization,smoker,score,single,empty
L1,pA_slice_007,nv,histo,45,male,back,True,1.5,3,
L2,pA_slice_010,mel,histo,,female,face,False,2.25,,NA
L3,pB2,bkl,consensus,70.5,unknown,unknown,true,-1e2,,
L4,scan,nv,follow_up,NA,,lower extremity,False,0,,
L5,pD_slice_001,df,histo,30,male,,True,N/A,,null
L6,pC_slice_003,vasc,histo,unknown,female,trunk,False,3,,
"""
FIELD_SETS = {
    "ham": ("age", "sex", "localization"),
    "all": ("score", "sex", "age", "smoker", "single", "empty", "localization", "dx_type", "absent"),
    "categorical_only": ("localization", "dx"),
}


def _write_png(path, mode, rng):
    shape = {"RGB": (30, 34, 3), "RGBA": (34, 30, 4), "L": (32, 32)}[mode]
    png.write_png(str(path), rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.fixture(scope="module")
def spine(tmp_path_factory):
    root = tmp_path_factory.mktemp("spine_data")
    rng = np.random.default_rng(7)
    img = root / "images"
    img.mkdir()
    for name, mode in SLICES:
        _write_png(img / name, mode, rng)
    (img / "pC_slice_003.png").write_bytes(b"\x89PNG\r\n\x1a\n not an image")
    (root / "labels.csv").write_text("image_id,label\n" + "".join(f"{n},{i % 6}\n" for i, n in enumerate(CENTRES)))
    (root / "responses.json").write_text(json.dumps([{"image_info": n, "description": f"slice {i} of the lumbar spine"}
                                                     for i, n in enumerate(CENTRES)]))
    (root / "metadata.csv").write_text(METADATA)
    return {"image_dir": str(img), "json_path": str(root / "responses.json"), "label_csv": str(root / "labels.csv"),
            "metadata_csv": str(root / "metadata.csv")}


MODES = {
    "sequence": dict(sequence=True, sequence_offsets=(-2, -1, 0, 1, 2)),
    "sequence_3": dict(sequence=True, sequence_offsets=(-1, 0, 1)),
    "multi_view": dict(multi_view=True, num_views=2),
    "multi_view_over_sequence": dict(multi_view=True, num_views=3, sequence=True),
    "sequence_over_pseudo": dict(sequence=True, pseudo_2p5d=True),
    "pseudo_2p5d": dict(pseudo_2p5d=True, pseudo_offsets=(-1, 0, 1)),
    "tabular": dict(tabular_enabled=True),
    "sequence_tabular": dict(sequence=True, tabular_enabled=True),
}


def _pair(paths, **opts):
    kw = dict(max_length=12, canvas=CANVAS, **opts)
    if kw.get("tabular_enabled"):
        kw["metadata_csv"] = paths["metadata_csv"]
    args = (paths["image_dir"], paths["json_path"], paths["label_csv"])
    return (jdata.MultimodalDataset(*args, jtok.WordPieceTokenizer.synthetic(30522), jdata.DatasetOptions(**kw)),
            tdata.MultimodalDataset(*args, ttok.WordPieceTokenizer.synthetic(30522), tdata.DatasetOptions(**kw)))


def _same_record(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "image_id":
            assert a[k] == b[k]
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.asarray(a[k]).shape == np.asarray(b[k]).shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_stacked_modes_match_jax_bit_for_bit(spine, mode, caplog):
    jd, td = _pair(spine, **MODES[mode])
    with caplog.at_level(logging.WARNING):
        for i in range(len(td)):
            _same_record(jd[i], td[i])
    recs = {td[i]["image_id"]: td[i] for i in range(len(td))}
    broken = recs["pC_slice_003.png"]["image"]
    assert broken.dtype == np.uint8 and not broken.any() and "pC_slice_003.png" in caplog.text
    o = td.opts
    lead = (o.num_views,) if o.multi_view else (len(o.sequence_offsets),) if o.sequence else ()
    assert broken.shape == (*lead, CANVAS, CANVAS, 3) and recs["missing_004.png"]["image"].shape == broken.shape


def test_neighbours_take_the_reference_name_then_the_padded_one_then_the_centre(spine):
    _, td = _pair(spine, sequence=True)
    jd, _ = _pair(spine, sequence=True)
    cases = {("pA_slice_007.png", -2): "pA_slice_005.png", ("pA_slice_007.png", -1): "pA_slice_6.png",
             ("pA_slice_007.png", 1): "pA_slice_007.png", ("pA_slice_007.png", 2): "pA_slice_009.png",
             ("pB2.png", 1): "pB2.png", ("pB2.png", 2): "pB4.png", ("pB2.png", -1): "pB1.png",
             ("scan.png", 1): "scan.png", ("pD_slice_001.png", -1): "pD_slice_001.png",
             ("pD_slice_001.png", 1): "pD_slice_002.png"}
    for (centre, off), want in cases.items():
        assert td.neighbor(centre, off) == want == jd._neighbor(centre, off), (centre, off)
    for name in ("pA_slice_007.png", "img_0099.jpg", "x.png", "a_1.b_2.png"):
        for off in (-3, -1, 0, 2):
            for pad in (False, True):
                assert tdata.neighbor_name(name, off, pad) == jdata.neighbor_name(name, off, pad)


def test_pseudo_2p5d_without_pil_reads_png_and_takes_pil_luma(spine, monkeypatch):
    jd, _ = _pair(spine, pseudo_2p5d=True)
    monkeypatch.setattr(tdata, "_pil", lambda: None)
    _, td = _pair(spine, pseudo_2p5d=True)
    decodes = png.decode_png.calls
    for i in range(len(td)):
        _same_record(jd[i], td[i])
    assert png.decode_png.calls > decodes


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_luma_is_pil_convert_l_bit_for_bit(mode):
    rng = np.random.default_rng(len(mode))
    shape = (64, 80) if mode == "L" else (64, 80, len(mode))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img.reshape(-1)[:8] = [0, 255, 127, 128, 1, 254, 0, 255]
    np.testing.assert_array_equal(tdata.luma(img), np.asarray(Image.fromarray(img, mode).convert("L")))


@pytest.mark.parametrize("mode", ["sequence", "multi_view", "sequence_tabular"])
def test_loader_collates_stacks_and_tabular_as_jax(spine, mode):
    jd, td = _pair(spine, **MODES[mode])
    kw = dict(batch_size=3, shuffle=True, seed=5)
    a, b = list(jloader.DataLoader(jd, **kw)), list(tloader.DataLoader(td, **kw))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        _same_record(x, y)
        assert y["image"].ndim == 5 and y["image"].dtype == np.uint8
        if "tabular" in y:
            assert y["tabular"].dtype == np.float32 and y["tabular"].shape == (3, td.tabular_dim)


@pytest.mark.parametrize("fields", list(FIELD_SETS))
@pytest.mark.parametrize("normalize", ["zscore", "none"])
def test_tabular_map_matches_the_pandas_version_bit_for_bit(spine, fields, normalize):
    want, wdim = jdata.build_tabular_map(spine["metadata_csv"], list(FIELD_SETS[fields]), normalize)
    got, gdim = tdata.build_tabular_map(spine["metadata_csv"], list(FIELD_SETS[fields]), normalize)
    assert gdim == wdim and list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tabular_map_edges_match_pandas(tmp_path):
    """Duplicate ids (the last wins), integer ids read as numbers, a bool column with an
    NA (object, so categorical), quoted fields, blank lines, a short row, a BOM."""
    text = ('﻿image_id,age,flag,site,n\n'
            '7,40,True,"back, upper",1\n'
            '\n'
            '8,,,face,2\n'
            '7,50,False,face,3\n'
            '9,60.5,True,"",4\n'
            '10\n')
    path = tmp_path / "edge.csv"
    path.write_text(text, encoding="utf-8")
    for fields in (["age", "flag", "site", "n"], ["n", "site"], ["flag"]):
        want, wdim = jdata.build_tabular_map(str(path), fields, "zscore")
        got, gdim = tdata.build_tabular_map(str(path), fields, "zscore")
        assert gdim == wdim and list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{fields} {k}")


def test_tabular_width_comes_from_the_metadata_csv(spine):
    cfg = tconfig.Config({"model": {"tabular": {"enabled": True, "fields": ["age", "sex", "localization"]}},
                          "data": {"metadata_csv": spine["metadata_csv"]}})
    assert tdata.tabular_dim(cfg) == jdata.build_tabular_map(spine["metadata_csv"], ["age", "sex", "localization"])[1]
    assert tdata.tabular_dim(tconfig.Config({"model": {}, "data": {"metadata_csv": spine["metadata_csv"]}})) == 0


@pytest.mark.parametrize("opt, item", [("llm_hidden_json", None), ("host_augment", "8")])
def test_only_llm_hidden_states_and_host_augmentation_stay_unported(spine, opt, item, tmp_path):
    """Only the host augmentation stays unported; the LLM hidden-state mode runs
    beside a stacked mode and the tabular one, record for record as JAX's."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
            tdata.DatasetOptions(**{opt: True}).check_ported()
    else:
        path = tmp_path / "hidden.json"
        path.write_text(json.dumps({n: {"first_hidden_state": [float(i)] * (i + 1), "last_hidden_state": [1.5] * 9}
                                    for i, n in enumerate(CENTRES[1:])}))
        tdata.DatasetOptions(llm_hidden_json=str(path)).check_ported()
        jd, td = _pair(spine, sequence=True, tabular_enabled=True, llm_hidden_json=str(path), llm_hidden_dim=4)
        for i in range(len(td)):
            _same_record(jd[i], td[i])
            assert td[i]["first_hidden"].shape == (4,)
    for mode in MODES.values():
        tdata.DatasetOptions(**mode).check_ported()


RESOLVED = {"spine_base_v1": "configs/spine/spine_base_v1.yml",
            "spine_sequence_lstm_v1": "configs/spine/spine_sequence_lstm_v1.yml",
            "spine_sequence_transformer_v1": "configs/spine/spine_sequence_transformer_v1.yml",
            "spine_multi_view_v1": "configs/spine/spine_multi_view_v1.yml",
            "spine_pseudo25d_v1": "configs/spine/spine_pseudo25d_v1.yml",
            "spine_global_local_v1": "configs/spine/spine_global_local_v1.yml",
            "spine_gate_entropy_v1": "configs/spine/spine_gate_entropy_v1.yml",
            "ham_gate_entropy_v1": "configs/ham/ham_gate_entropy_v1.yml",
            "ham_tabular_v1": "configs/ham/ham_tabular_v1.yml"}


@pytest.mark.parametrize("name", sorted(RESOLVED))
def test_the_spine_and_branch_json_configs_are_their_yaml_resolved(name):
    assert tconfig.load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json").to_dict() == \
        jconfig.load_config(REPO / RESOLVED[name]).to_dict()


@pytest.mark.parametrize("name", sorted(RESOLVED))
def test_dataset_options_from_a_config_are_the_jax_trainers(name, spine):
    """``DatasetOptions.from_config`` reads each knob the JAX Trainer's loader reads."""
    cfg = tconfig.load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json")
    o = tdata.DatasetOptions.from_config(cfg, "baseline", "train")
    d = cfg.to_dict()
    seq, mv, p25 = (d["data"].get(k, {}) for k in ("sequence", "multi_view", "pseudo_2p5d"))
    assert (o.sequence, o.multi_view, o.pseudo_2p5d) == (bool(seq.get("enabled")), bool(mv.get("enabled")),
                                                          bool(p25.get("enabled")))
    assert o.sequence_offsets == tuple(seq.get("offsets", (-2, -1, 0, 1, 2)))
    assert o.pseudo_offsets == tuple(p25.get("offsets", (-1, 0, 1))) and o.num_views == mv.get("num_views", 2)
    assert o.tabular_enabled == bool(d["model"].get("tabular", {}).get("enabled"))
    assert o.metadata_csv == d["data"].get("metadata_csv") and o.canvas == 256 and o.max_length == 128
