"""Pretrained weights named in a config: the full model and its two towers.

Counterpart of the JAX Trainer's ``_load_pretrained``
(``mdhs_tpu/train/trainer.py:1060-1158``), which the eval CLIs
(``cli/common.py::Predictor``) and the trainer both call:

- ``model.pretrained_path``: the full model, any file ``load_weights`` reads
  (a port checkpoint, a JAX msgpack, a reference torch state dict, which for
  the baseline family is ``convert_baseline_full``'s layout under the port's
  own names).
- ``model.image_encoder.pretrained_path``: MIBF's torchvision ResNet50 (its
  1000-class ``fc`` is skipped by the tolerant merge, as a shape mismatch),
  the baseline's torchvision ResNet18 / ResNet34 (``model.image_encoder.
  backbone``) under ``image_encoder.model.``, its ``fc`` dropped, as
  ``convert_resnet`` reads the trunk only, or ConNexT's HF ``ConvNextModel``
  (a ``convnext.`` prefix stripped, the
  final ``layernorm`` and any ``classifier`` dropped, as
  ``convert_convnext_hf`` drops them). The torchvision ConvNeXt naming
  (``features.*``) raises: ROADMAP Queue 1 item 11.
- ``model.text_encoder.pretrained_path``: an HF ``BertModel``, rooted at
  ``bert.`` or at ``embeddings.``; the pooler is dropped, as
  ``convert_bert`` returns it apart.

The port's modules carry the reference's torch names, so a tower's file
loads under its prefix (``image_encoder.``, ``image_encoder.model.``,
``text_encoder.bert.``, the baseline's ``text_encoder.model.``) through
``core/checkpoint.py::merge_tolerant``. A file missing one of the tower's
names raises ``ValueError`` naming the path and the family, as the JAX
``convert_context`` does. A ``.msgpack`` tower path is a whole JAX
checkpoint, loaded as the full model, as in JAX.
"""

from __future__ import annotations

import logging
from typing import Mapping

from torch import nn

from .checkpoint import is_flax_msgpack, load_torch_file, load_weights, merge_tolerant

log = logging.getLogger(__name__)

PRETRAINED_KEYS = ("model.pretrained_path", "model.image_encoder.pretrained_path",
                   "model.text_encoder.pretrained_path")


def _under(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _image_tower(sd: dict, family: str) -> tuple[dict, str]:
    """(the tower's state dict under the port's tower names, what the file should be)."""
    if family == "mibf":
        return sd, "torchvision resnet50"
    if family == "baseline":
        return {k: v for k, v in sd.items() if not k.startswith("fc.")}, "torchvision ResNet"
    if any(k.startswith("features.") for k in sd) and not any("patch_embeddings" in k for k in sd):
        raise NotImplementedError("a torchvision ConvNeXt (features.*) state dict is not read yet: "
                                  "ROADMAP Queue 1 item 11; give an HF ConvNextModel")
    if any(k.startswith("convnext.") for k in sd):
        sd = _under(sd, "convnext.")
    return {k: v for k, v in sd.items() if not k.startswith(("layernorm.", "classifier.", "pooler."))}, \
        "ConvNeXt (HF ConvNextModel)"


def _text_tower(sd: dict) -> dict:
    if any(k.startswith("bert.") for k in sd):
        sd = _under(sd, "bert.")
    return {k: v for k, v in sd.items() if not k.startswith(("pooler.", "cls."))}


def _load_tower(model: nn.Module, path: str, family: str, tower: str) -> None:
    sd = load_torch_file(path)
    baseline = family == "baseline"
    if tower == "image":
        sub, what = _image_tower(sd, family)
        prefix = "image_encoder.model." if baseline else "image_encoder."
    else:
        sub, what = _text_tower(sd), "HF BertModel"
        prefix = "text_encoder.model." if baseline else "text_encoder.bert."
    target = model.state_dict()
    loaded = {prefix + k: v for k, v in sub.items()}
    skip = ("image_encoder.fc.",) if family == "mibf" else ()  # the 768-out head, not the backbone's
    missing = [k for k in target if k.startswith(prefix) and not k.startswith(skip)
               and not k.endswith("num_batches_tracked") and k not in loaded]
    if missing:
        raise ValueError(f"{path} does not look like a {what} state dict for the '{family}' family "
                         f"(missing key {missing[0][len(prefix):]!r})")
    model.load_state_dict(merge_tolerant(target, loaded, warn_missing=False), strict=True)


def load_pretrained(model: nn.Module, cfg, family: str) -> list[str]:
    """Load the config's pretrained weights into ``model`` (the full model first,
    then the image tower, then the text tower); the paths it loaded."""
    done = []
    full, img, txt = (cfg.get(k) for k in PRETRAINED_KEYS)
    if full:
        load_weights(model, full, family)
        done.append(full)
    for path, tower in ((img, "image"), (txt, "text")):
        if not path:
            continue
        if is_flax_msgpack(path):
            load_weights(model, path, family)
        else:
            _load_tower(model, path, family, tower)
        log.info("loaded pretrained %s tower from %s", tower, path)
        done.append(path)
    return done

