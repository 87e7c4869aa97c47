"""Host-side dataset join: image directory + JSON descriptions + label CSV.

Counterpart of ``mdhs_tpu/data/datasets.py`` in single-image mode:
- JSON records keyed by the basename of image_info / image_name /
  image_path, the text from description / response / caption;
- a label CSV with its *image* and *label* columns found by name, or every
  image of the directory (label -1) where there is no CSV;
- a missing description is an empty text; ``clean_cjk_text`` strips CJK;
- each image becomes a uint8 canvas: the shortest side resized to
  ``canvas`` and center-cropped, by the native resampler
  (``mdhs_tpu_torch/native.py``) and by PIL where it does not build;
- an image that fails to load becomes a zero canvas, with a warning.

Images are decoded by PIL where it imports, else by ``data/png.py``, which
reads PNG only; anything else raises there, so the record gets the zero
canvas and the warning names PIL.

The other modes of the JAX dataset (multi-view, sequence, pseudo-2.5D, the
tabular branch, LLM hidden states, host augmentation) raise
``NotImplementedError`` naming their ROADMAP items.

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
    """uint8 (H, W, 3) -> (size, size, 3) canvas: the native resampler, or PIL's
    resize where the library does not build; neither raises."""
    out = native.resize_center_square(img, size)
    if out is not None:
        return out
    Image = _pil()
    if Image is None:
        raise RuntimeError("no image resampler: the native library did not build and PIL does not import")
    return np.asarray(_resize_center_square(Image.fromarray(img), size), np.uint8)


@dataclass
class DatasetOptions:
    """The fields of the JAX ``DatasetOptions`` that single-image mode reads, and
    the switches of the modes not ported, which must stay off."""

    max_length: int = 128
    extra_image_dirs: tuple = ()
    clean_cjk_text: bool = False
    canvas: int = CANVAS
    cache: bool = True  # keep each canvas: made once, reused across epochs
    multi_view: bool = False
    sequence: bool = False
    pseudo_2p5d: bool = False
    tabular_enabled: bool = False
    llm_hidden_json: Optional[str] = None
    host_augment: bool = False

    def check_ported(self) -> None:
        for flag, what, item in ((self.multi_view, "multi-view", "10"), (self.sequence, "sequence", "10"),
                                 (self.pseudo_2p5d, "pseudo-2.5D", "10"), (self.tabular_enabled, "tabular", "10"),
                                 (self.llm_hidden_json, "LLM hidden-state", "11"),
                                 (self.host_augment, "host augmentation", "8")):
            if flag:
                raise NotImplementedError(f"the {what} data mode is not ported yet: ROADMAP Queue 1 item {item}")


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

    def _load_canvas(self, image_id: str) -> np.ndarray:
        if self.opts.cache and image_id in self._canvas_cache:
            return self._canvas_cache[image_id]
        path = self._find_image(image_id)
        if path is None:
            raise FileNotFoundError(image_id)
        t0 = time.perf_counter()
        img = open_rgb(path)
        t1 = time.perf_counter()
        arr = canvas_array(img, self.opts.canvas)
        HOST_MS["decode"] += (t1 - t0) * 1e3
        HOST_MS["resize"] += (time.perf_counter() - t1) * 1e3
        if self.opts.cache:
            self._canvas_cache[image_id] = arr
        return arr

    def __getitem__(self, idx: int) -> dict:
        item = self.metadata[idx]
        image_id = item["image_id"]
        S = self.opts.canvas
        try:
            image = self._load_canvas(image_id)
        except Exception as exc:  # the reference's tolerance: a zero image on failure
            log.warning("image load failed for %s: %s", image_id, exc)
            image = np.zeros((S, S, 3), np.uint8)
        t0 = time.perf_counter()
        input_ids, attention_mask = self.tokenizer.encode(item["description"], self.opts.max_length)
        HOST_MS["tokenize"] += (time.perf_counter() - t0) * 1e3
        return {"image": image, "input_ids": input_ids, "attention_mask": attention_mask,
                "label": np.int32(item["label"]), "image_id": image_id}
