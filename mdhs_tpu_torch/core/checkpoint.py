"""Checkpoints: the port's own format, reference torch files and JAX msgpack.

Counterpart of ``mdhs_tpu/core/checkpoint.py`` (``save_checkpoint``,
``load_checkpoint``, ``merge_tolerant``) and of the JAX Trainer's
``load_weights`` / ``_is_flax_msgpack`` / ``_import_full_torch``
(``mdhs_tpu/train/trainer.py:999-1058, 1160-1215``):

- ``save_checkpoint`` writes ``torch.save({"state_dict", "metadata"})`` with
  every floating tensor as float32 on the CPU, under the reference's torch
  names. So ``mdhs_tpu.core.convert.load_torch_state_dict`` and the JAX
  family converters (``convert_mibf_full``, ``convert_baseline_full``,
  ``convert_connext_full``) read it as they stand.
- ``load_state_dict_file`` reads such a file, or a reference torch
  checkpoint (``.pth``, ``.pt``, ``.bin``, a Lightning ``.ckpt`` holding
  ``state_dict``, ``.safetensors``), stripping a leading ``module.`` as
  the JAX converters' ``_strip_prefix`` does, or a JAX ``save_checkpoint``
  msgpack file, whose trees the inverse converters of ``core/convert.py``
  turn into torch names. The format is found from the file's first bytes,
  as ``_is_flax_msgpack`` finds it; ``msgpack`` is imported only for such a
  file (a machine may have none).
- ``merge_tolerant`` copies every tensor whose name and shape match, cast to
  the target's dtype, and warns about unexpected, shape-mismatched and
  missing names with ``mdhs_tpu``'s messages and key sets.
  ``load_weights(model, path)`` loads a file into a model through it.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

log = logging.getLogger(__name__)


def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().to("cpu")
    return (t.float() if t.is_floating_point() else t).contiguous().clone()


def save_checkpoint(path: str, model: nn.Module, metadata: Optional[Mapping] = None) -> None:
    """``torch.save({"state_dict": float32 CPU tensors, "metadata": ...})``, written
    to a temporary file renamed into place."""
    state = {"state_dict": {k: _host_tensor(v) for k, v in model.state_dict().items()},
             "metadata": dict(metadata or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def is_flax_msgpack(path: str) -> bool:
    """A JAX ``save_checkpoint`` file: a msgpack map (fixmap 0x81-0x8f, map16 0xde,
    map32 0xdf) where torch files start with "PK" (zip), 0x80 (pickle) or a
    safetensors header length. 0x80 alone, an empty msgpack map, is read as pickle."""
    if path.endswith(".msgpack"):
        return True
    try:
        with open(path, "rb") as f:
            head = f.read(1)
    except OSError:
        return False
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore for a checkpoint's trees: nested dicts whose
    leaves are numpy arrays (extension type 1) or numpy scalars (type 3)."""
    import msgpack

    def ext(code, payload):
        if code == 1:
            return _ndarray(payload)
        if code == 3:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack extension type {code} is not a checkpoint leaf")

    return msgpack.unpackb(data, ext_hook=ext, raw=False)


def load_checkpoint(path: str) -> dict:
    """A JAX msgpack checkpoint's trees (``params``, ``batch_stats``, ``kan_state``, ...)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _strip_module(sd: Mapping) -> dict:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_torch_file(path: str) -> dict[str, torch.Tensor]:
    """A torch or safetensors checkpoint's state_dict (``state_dict`` inside a
    Lightning or port file), ``module.`` stripped."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return _strip_module(load_file(path))
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return _strip_module(state)


def state_dict_from_jax(trees: Mapping, family: str, model: nn.Module) -> dict[str, torch.Tensor]:
    """A JAX checkpoint's trees -> the port model's torch names (``core/convert.py``)."""
    from . import convert

    params, stats, kan = trees.get("params", {}), trees.get("batch_stats", {}), trees.get("kan_state", {})
    try:
        if family == "mibf":
            sd = convert.mibf_state_dict_from_jax(params, stats)
        elif family == "baseline":
            sd = convert.baseline_state_dict_from_jax(params, stats, kan, fusion_type=model.cfg.fusion_type,
                                                      classifier_type=model.cfg.classifier_type)
        elif family == "connext":
            sd = convert.connext_state_dict_from_jax(params, kan)
        else:
            raise ValueError(f"unknown model family: {family}")
    except KeyError as exc:
        raise ValueError(f"the checkpoint does not look like a {family} model (missing key {exc})") from exc
    # BatchNorm's num_batches_tracked has no JAX counterpart: the model's own stays
    sd.update({k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")})
    return sd


def load_state_dict_file(path: str, family: str, model: nn.Module) -> dict:
    """Any checkpoint ``load_weights`` takes, as a {torch name: tensor or array} dict."""
    if is_flax_msgpack(path):
        return state_dict_from_jax(load_checkpoint(path), family, model)
    return load_torch_file(path)


def merge_tolerant(target: Mapping, loaded: Mapping, prefix: str = "", warn_missing: bool = True) -> dict:
    """strict=False-style merge of flat {name: tensor} dicts: take each loaded
    value whose name and shape match, cast to the target's dtype; warn about
    shape mismatches, unexpected and (``warn_missing``) missing names."""
    merged = dict(target)
    loaded_keys = set()
    for key, val in loaded.items():
        if key in target:
            tgt = target[key]
            if tuple(tgt.shape) == tuple(np.shape(val)):
                val = val if isinstance(val, torch.Tensor) else torch.from_numpy(np.array(val))
                merged[key] = val.to(tgt.dtype)
                loaded_keys.add(key)
            else:
                log.warning("shape mismatch for %s%s: %s vs %s", prefix, key, tuple(np.shape(val)), tuple(tgt.shape))
        else:
            log.warning("unexpected key in checkpoint: %s%s", prefix, key)
    if warn_missing:
        for key in target:
            if key not in loaded_keys and key not in loaded:
                log.warning("missing key in checkpoint: %s%s", prefix, key)
    return merged


def load_weights(model: nn.Module, path: str, family: str) -> None:
    """Load a checkpoint of any format ``load_state_dict_file`` reads into
    ``model``, tolerantly (``merge_tolerant``), each value copied into the
    parameter's own dtype, device and layout."""
    target = model.state_dict()
    merged = merge_tolerant(target, load_state_dict_file(path, family, model))
    model.load_state_dict(merged, strict=True)
    log.info("loaded weights from %s", path)
