"""Host-side dataset join: image directory + JSON descriptions + label CSV.

Counterpart of ``mdhs_tpu/data/datasets.py``:
- JSON records keyed by the basename of image_info / image_name /
  image_path, the text from description / response / caption;
- a label CSV with its *image* and *label* columns found by name, or every
  image of the directory (label -1) where there is no CSV;
- a missing description is an empty text; ``clean_cjk_text`` strips CJK;
- each image becomes a uint8 canvas: the shortest side resized to
  ``canvas`` and center-cropped, by the native resampler
  (``mdhs_tpu_torch/native.py``) and by PIL where it does not build;
- the stacked modes (``datasets.py:338-382``), in JAX's precedence:
  ``multi_view`` stacks the same canvas ``num_views`` times (the device
  augments each view), (V, S, S, 3); ``sequence`` the canvases of the
  neighbouring slices at ``sequence_offsets``, (T, S, S, 3);
  ``pseudo_2p5d`` three gray neighbours as the channels, (S, S, 3). A
  neighbour's name shifts the number before the extension (``neighbor_name``):
  the reference-intent name, then the zero-padded one, then the centre slice
  (``MultimodalDataset.neighbor``). Gray is PIL's ``convert("L")`` before the
  resize, or, without PIL, its luma exactly (``luma``);
- an image that fails to load gives zeros of the mode's own shape, with a
  warning;
- ``tabular_enabled``: each record's float32 ``tabular`` vector from the
  metadata CSV (``build_tabular_map``, pandas' rules without pandas), zeros
  for an image the CSV does not list.

Images are decoded by PIL where it imports, else by ``data/png.py``, which
reads PNG only; anything else raises there, so the record gets the zero
canvas and the warning names PIL.

LLM hidden states and the host augmentation raise ``NotImplementedError``
naming their ROADMAP items.

``HOST_MS`` sums the host time of decoding, resizing and tokenizing (ms)
over every record any dataset makes; ``reset_host_ms`` sets it to zero.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import re
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import native
from . import png

log = logging.getLogger(__name__)

CANVAS = 256  # host canvas: shortest side resized to 256, center-cropped square
HOST_MS = {"decode": 0.0, "resize": 0.0, "tokenize": 0.0}


def reset_host_ms() -> None:
    for k in HOST_MS:
        HOST_MS[k] = 0.0


def build_description_map(json_path: str) -> dict[str, str]:
    with open(json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out = {}
    for item in data:
        key = None
        for k in ("image_info", "image_name", "image_path"):
            if k in item:
                key = os.path.basename(str(item[k]))
                break
        if not key:
            continue
        desc = item.get("description") or item.get("response") or item.get("caption")
        if desc is None:
            continue
        out[key] = desc
    return out


def load_label_map(csv_path: str) -> dict[str, int]:
    with open(csv_path, "r", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        cols = reader.fieldnames or []
        image_col = next(c for c in cols if "image" in c)
        label_col = next(c for c in cols if "label" in c)
        return {row[image_col]: int(row[label_col]) for row in reader}


def clean_cjk(text: str) -> str:
    """Strip CJK characters (the reference's dataset_spine.py:33-34)."""
    return re.sub(r"[一-鿿　-〿＀-￯]", "", text or "").strip()


def neighbor_name(image_id: str, offset: int, pad: bool = False) -> str:
    """A neighbouring slice's file name: the number before the extension shifted by
    ``offset``, clamped at 0 (the reference's intent, ``datasets.py:74-97``), as a
    plain int, or with the original digit width where ``pad``."""
    if offset == 0:
        return image_id
    m = re.match(r"^(.*_)(\d+)(\.[^.]+)$", image_id) or re.match(r"^(.*?)(\d+)(\.[^.]+)$", image_id)
    if not m:
        return image_id
    prefix, idx_str, suffix = m.groups()
    idx = max(0, int(idx_str) + offset)
    if pad:
        return f"{prefix}{idx:0{len(idx_str)}d}{suffix}"
    return f"{prefix}{idx}{suffix}"


def _pil():
    """PIL's Image module, or None where PIL does not import."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def open_rgb(path: str) -> np.ndarray:
    """An image file as uint8 (H, W, 3): PIL's ``convert("RGB")`` where PIL
    imports, else the PNG reader, gray replicated and alpha dropped as that
    conversion does."""
    Image = _pil()
    if Image is not None:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), np.uint8)
    img = png.read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def luma(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W) gray of an (H, W) gray, RGB or RGBA image, as PIL's ``convert("L")``:
    ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16``, alpha ignored."""
    if img.ndim == 2:
        return img
    c = img[..., :3].astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def open_gray(path: str) -> np.ndarray:
    """An image file as uint8 (H, W): PIL's ``convert("L")`` where PIL imports, else
    the PNG reader and ``luma``."""
    Image = _pil()
    if Image is not None:
        with Image.open(path) as img:
            return np.asarray(img.convert("L"), np.uint8)
    return luma(png.read_png(path))


def _resize_center_square(img, size: int):
    """PIL bilinear: shortest side -> size, then center crop size x size."""
    Image = _pil()
    w, h = img.size
    if w <= h:
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nh, nw = size, max(size, int(round(w * size / h)))
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - size) // 2
    top = (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def canvas_array(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, 3) or (H, W) -> (size, size[, 3]) canvas: the native resampler, or
    PIL's resize where the library does not build; neither raises."""
    out = native.resize_center_square(img, size)
    if out is not None:
        return out
    Image = _pil()
    if Image is None:
        raise RuntimeError("no image resampler: the native library did not build and PIL does not import")
    return np.asarray(_resize_center_square(Image.fromarray(img), size), np.uint8)


# pandas' default NA strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
                       "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT = re.compile(r"^\s*[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf|infinity)\s*$", re.IGNORECASE)
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


def _column(raw: list) -> tuple[str, list]:
    """A CSV column's values (None for an NA string) as pandas' parser types them:
    ("int", ints) where every value is an integer, ("float", floats with NaN) where
    every present value is a number, ("bool", bools) where every value is a boolean
    string, else ("object", the strings with None); an all-NA column is float."""
    present = [v for v in raw if v is not None]
    if len(present) == len(raw) and present and all(_INT.match(v) for v in present):
        return "int", [int(v) for v in raw]
    if all(_FLOAT.match(v) for v in present):
        return "float", [float(v) if v is not None else float("nan") for v in raw]
    if len(present) == len(raw) and all(v in _BOOL for v in present):
        return "bool", [_BOOL[v] for v in raw]
    return "object", raw


def _as_str(kind: str, values: list) -> list:
    """pandas' ``astype(str)`` of a typed column."""
    if kind == "object":
        return ["nan" if v is None else v for v in values]
    return [str(v) for v in values]


def _to_numeric(kind: str, values: list) -> np.ndarray:
    """pandas' ``to_numeric(errors="coerce")`` as float64, NaN where a value is no number."""
    if kind != "object":
        return np.asarray(values, np.float64)
    return np.asarray([float(v) if v is not None and _FLOAT.match(v) else np.nan for v in values], np.float64)


def _nan_mean_std(vals: np.ndarray) -> tuple[float, float]:
    """pandas' ``Series.mean()`` and ``std()`` (ddof 1) of a float64 column with NaN,
    in its order of operations (``nanops.nanmean`` / ``nanvar``: the NaNs zeroed in
    place, whole-array sums); the std is NaN for a single value."""
    mask = np.isnan(vals)
    count = int((~mask).sum())
    filled = np.where(mask, 0.0, vals)
    mean = filled.sum(dtype=np.float64) / count
    if count <= 1:
        return float(mean), float("nan")
    sqr = np.where(mask, 0.0, (mean - filled) ** 2)
    return float(mean), float(np.sqrt(sqr.sum(dtype=np.float64) / (count - 1)))


def read_csv_columns(path: str) -> dict[str, list]:
    """A CSV's columns as lists of strings, None where pandas reads NA (its default NA
    strings, missing trailing fields); blank lines skipped."""
    with open(path, "r", encoding="utf-8-sig", newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    return {name: [None if i >= len(r) or r[i] in NA_VALUES else r[i] for r in body]
            for i, name in enumerate(header)}


def build_tabular_map(metadata_csv: str, fields, normalize: str = "zscore") -> tuple[dict, int]:
    """(image id without extension -> float32 vector, its width), as the JAX
    package's pandas version (``datasets.py:126-183``) gives it: ``age`` and every
    field pandas reads as numeric (bool included) first, NaN filled with the mean,
    z-scored where ``normalize == "zscore"`` (the sample std, 0 -> 1, NaN for a
    single value; mean 0 and std 1 for a field with no value); then each other
    field one-hot over its sorted strings plus "unknown", which takes NA and
    unseen strings; fields in ``fields`` order within each group, fields the CSV
    lacks left out."""
    cols = read_csv_columns(metadata_csv)
    typed = {name: _column(values) for name, values in cols.items()}
    ids = _as_str(*typed["image_id"])
    n = len(ids)
    numeric, categorical = [], []
    for f_ in fields:
        if f_ not in cols:
            continue
        (numeric if f_ == "age" or typed[f_][0] != "object" else categorical).append(f_)
    blocks = []
    for f_ in numeric:
        vals = _to_numeric(*typed[f_])
        if np.isnan(vals).all():
            mean, std = 0.0, 1.0
        else:
            mean, std = _nan_mean_std(vals)
            std = std if std != 0.0 else 1.0
        vals = np.where(np.isnan(vals), mean, vals)
        blocks.append(((vals - mean) / std if normalize == "zscore" else vals).reshape(n, 1))
    for f_ in categorical:
        raw = typed[f_][1]
        cats = sorted({v for v in raw if v is not None})
        if "unknown" not in cats:
            cats.append("unknown")
        index = {c: i for i, c in enumerate(cats)}
        idx = np.asarray([index["unknown"] if v is None else index.get(v, index["unknown"]) for v in raw], np.intp)
        blocks.append(np.eye(len(cats), dtype=np.float64)[idx])
    mat = np.concatenate(blocks, axis=1).astype(np.float32) if blocks else np.zeros((n, 0), np.float32)
    dim = mat.shape[1]
    return dict(zip((os.path.splitext(i)[0] for i in ids), mat)), dim


def tabular_dim(cfg) -> int:
    """The tabular branch's input width of a config: that of
    ``build_tabular_map`` over ``data.metadata_csv`` where ``model.tabular`` is
    enabled (the JAX Trainer's predict-only construction, ``trainer.py:217-236``),
    else 0."""
    if not cfg.get("model.tabular.enabled", False) or not cfg.get("data.metadata_csv"):
        return 0
    return build_tabular_map(cfg.get("data.metadata_csv"), tabular_fields(cfg),
                             cfg.get("model.tabular.normalize", "zscore"))[1]


def tabular_fields(cfg) -> tuple:
    return tuple(cfg.get("model.tabular.fields", ["age", "sex", "localization"]) or [])


@dataclass
class DatasetOptions:
    """The fields of the JAX ``DatasetOptions`` the port reads, and the switches of
    the modes not ported, which must stay off."""

    max_length: int = 128
    tabular_enabled: bool = False
    tabular_fields: tuple = ("age", "sex", "localization")
    tabular_normalize: str = "zscore"
    metadata_csv: Optional[str] = None
    extra_image_dirs: tuple = ()
    pseudo_2p5d: bool = False
    pseudo_offsets: tuple = (-1, 0, 1)
    sequence: bool = False
    sequence_offsets: tuple = (-2, -1, 0, 1, 2)
    multi_view: bool = False
    num_views: int = 2
    clean_cjk_text: bool = False
    canvas: int = CANVAS
    cache: bool = True  # keep each canvas: made once, reused across epochs
    llm_hidden_json: Optional[str] = None
    host_augment: bool = False

    def check_ported(self) -> None:
        if self.llm_hidden_json:
            raise NotImplementedError("the LLM hidden-state data mode is not ported yet: ROADMAP Queue 1 item 11")
        if self.host_augment:
            raise NotImplementedError("the host augmentation data mode is not ported yet: ROADMAP Queue 1 item 8")

    @classmethod
    def from_config(cls, cfg, family: str, split: str, **overrides) -> "DatasetOptions":
        """The options the JAX Trainer gives ``split``'s dataset (``trainer.py:299-373``)."""
        d = cfg.get("data")
        opts = dict(
            max_length=cfg.get("tokenizer.max_length", 128),
            tabular_enabled=bool(cfg.get("model.tabular.enabled", False)),
            tabular_fields=tabular_fields(cfg),
            tabular_normalize=cfg.get("model.tabular.normalize", "zscore"),
            metadata_csv=d.get("metadata_csv"),
            extra_image_dirs=tuple(d.get("extra_image_dirs", []) or []),
            pseudo_2p5d=bool(d.get("pseudo_2p5d.enabled", False)),
            pseudo_offsets=tuple(d.get("pseudo_2p5d.offsets", [-1, 0, 1]) or []),
            sequence=bool(d.get("sequence.enabled", False)),
            sequence_offsets=tuple(d.get("sequence.offsets", [-2, -1, 0, 1, 2]) or []),
            multi_view=bool(d.get("multi_view.enabled", False)),
            num_views=int(d.get("multi_view.num_views", 2)),
            clean_cjk_text=family == "mibf",
            canvas=int(cfg.get("data.canvas", 256)),
            llm_hidden_json=d.get(f"{split}_llm_hidden_json") or d.get("llm_hidden_json"),
            cache=bool(d.get("cache", True)),
        )
        opts.update(overrides)
        return cls(**opts)


class MultimodalDataset:
    """Joined records with uint8 canvas images; indexable, numpy records."""

    def __init__(self, image_dir: str, json_path: Optional[str], csv_path: Optional[str], tokenizer,
                 options: DatasetOptions | None = None):
        self.opts = options or DatasetOptions()
        self.opts.check_ported()
        self.image_dirs = [image_dir, *self.opts.extra_image_dirs]
        self.tokenizer = tokenizer
        self._canvas_cache: dict = {}

        desc_map = build_description_map(json_path) if json_path else {}
        if csv_path:
            label_map = load_label_map(csv_path)
        else:  # unlabeled predict mode: every image in the directory
            exts = (".jpg", ".jpeg", ".png", ".bmp")
            label_map = {f: -1 for f in sorted(os.listdir(image_dir)) if f.lower().endswith(exts)}

        self.metadata = []
        missing = 0
        for image_id, label in label_map.items():
            desc = desc_map.get(image_id, "")
            if not desc:
                missing += 1
            if self.opts.clean_cjk_text:
                desc = clean_cjk(desc)
            self.metadata.append({"image_id": image_id, "description": desc, "label": int(label)})
        log.info("loaded %d records (%d without description)", len(self.metadata), missing)
        if not self.metadata:
            raise ValueError("dataset join produced no records; check paths")

        self.tabular_map, self.tabular_dim = None, 0
        if self.opts.tabular_enabled:
            if not self.opts.metadata_csv:
                raise ValueError("tabular_enabled requires metadata_csv")
            self.tabular_map, self.tabular_dim = build_tabular_map(
                self.opts.metadata_csv, list(self.opts.tabular_fields), self.opts.tabular_normalize)

    def __len__(self):
        return len(self.metadata)

    @property
    def labels(self):
        return [m["label"] for m in self.metadata]

    def _find_image(self, image_id: str) -> Optional[str]:
        for d in self.image_dirs:
            p = os.path.join(d, image_id)
            if os.path.exists(p):
                return p
        return None

    def neighbor(self, image_id: str, offset: int) -> str:
        """A neighbouring slice's id: the reference-intent name, then the zero-padded
        one, then the centre slice itself where neither exists (``datasets.py:291-302``)."""
        nid = neighbor_name(image_id, offset)
        if self._find_image(nid) is not None:
            return nid
        padded = neighbor_name(image_id, offset, pad=True)
        if self._find_image(padded) is not None:
            return padded
        return image_id

    def _load_canvas(self, image_id: str, gray: bool = False) -> np.ndarray:
        key = (image_id, gray)
        if self.opts.cache and key in self._canvas_cache:
            return self._canvas_cache[key]
        path = self._find_image(image_id)
        if path is None:
            raise FileNotFoundError(image_id)
        t0 = time.perf_counter()
        img = open_gray(path) if gray else open_rgb(path)
        t1 = time.perf_counter()
        arr = canvas_array(img, self.opts.canvas)
        HOST_MS["decode"] += (t1 - t0) * 1e3
        HOST_MS["resize"] += (time.perf_counter() - t1) * 1e3
        if self.opts.cache:
            self._canvas_cache[key] = arr
        return arr

    def _image(self, image_id: str) -> np.ndarray:
        o = self.opts
        if o.multi_view:
            return np.stack([self._load_canvas(image_id)] * o.num_views, axis=0)
        if o.sequence:
            return np.stack([self._load_canvas(self.neighbor(image_id, off)) for off in o.sequence_offsets], axis=0)
        if o.pseudo_2p5d:
            return np.stack([self._load_canvas(self.neighbor(image_id, off), gray=True) for off in o.pseudo_offsets],
                            axis=2)
        return self._load_canvas(image_id)

    def __getitem__(self, idx: int) -> dict:
        item = self.metadata[idx]
        image_id = item["image_id"]
        o = self.opts
        S = o.canvas
        try:
            image = self._image(image_id)
        except Exception as exc:  # the reference's tolerance: zeros of the mode's shape on failure
            log.warning("image load failed for %s: %s", image_id, exc)
            lead = (o.num_views,) if o.multi_view else (len(o.sequence_offsets),) if o.sequence else ()
            image = np.zeros((*lead, S, S, 3), np.uint8)
        t0 = time.perf_counter()
        input_ids, attention_mask = self.tokenizer.encode(item["description"], o.max_length)
        HOST_MS["tokenize"] += (time.perf_counter() - t0) * 1e3
        record = {"image": image, "input_ids": input_ids, "attention_mask": attention_mask,
                  "label": np.int32(item["label"]), "image_id": image_id}
        if self.tabular_map is not None:
            record["tabular"] = self.tabular_map.get(os.path.splitext(image_id)[0],
                                                     np.zeros(self.tabular_dim, np.float32))
        return record
