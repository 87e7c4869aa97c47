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
  the JAX converters' ``_strip_prefix`` does (for the ``connext`` family a
  reference file goes through ``convert_connext_full``'s reading,
  ``connext_reference_state_dict``: the Lightning wrappers ``net.net.`` /
  ``net.`` peeled, a torchvision-named image tower renamed, a missing name
  and a Mamba-fusion model refused; a port file, which carries
  ``metadata``, is read as it stands), or a JAX ``save_checkpoint``
  msgpack file, whose trees the inverse converters of ``core/convert.py``
  turn into torch names. The format is found from the file's first bytes,
  as ``_is_flax_msgpack`` finds it; ``msgpack`` is imported only for such a
  file (a machine may have none).
- ``merge_tolerant`` copies every tensor whose name and shape match, cast to
  the target's dtype, and warns about unexpected, shape-mismatched and
  missing names with ``mdhs_tpu``'s messages and key sets.
  ``load_weights(model, path)`` loads a file into a model through it.
- ``TopKCheckpointManager`` (``mdhs_tpu/core/checkpoint.py:79-136``) keeps
  the k best of a run's epoch checkpoints by a metric, higher being better,
  as ``{prefix}_{epoch}_val_acc_{metric:.2f}.pt`` beside an atomically
  written ``checkpoints.json`` index, and ``last.pt``. Each is a
  ``save_state`` file, which ``load_torch_file`` (so ``run_predict
  --model_path``) reads as any port checkpoint; ``last.pt`` also carries
  what a resume needs under ``resume`` (``train/trainer.py``).
"""

from __future__ import annotations

import json
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


CHECKPOINT_EXT = ".pt"


def host_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every tensor on the CPU, the floating ones as float32."""
    return {k: _host_tensor(v) for k, v in state_dict.items()}


def save_state(path: str, state: Mapping) -> None:
    """``torch.save(state)`` to a temporary file renamed into place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(dict(state), tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, model: nn.Module, metadata: Optional[Mapping] = None) -> None:
    """``torch.save({"state_dict": float32 CPU tensors, "metadata": ...})``, written
    to a temporary file renamed into place."""
    save_state(path, {"state_dict": host_state_dict(model.state_dict()), "metadata": dict(metadata or {})})


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


def _read_torch_file(path: str) -> tuple[dict[str, torch.Tensor], bool]:
    """(the state dict, ``module.`` stripped; whether the file is the port's own:
    a dict holding ``state_dict`` beside the ``metadata`` every port file has)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return _strip_module(load_file(path)), False
    state = torch.load(path, map_location="cpu", weights_only=True)
    port = isinstance(state, dict) and "state_dict" in state and "metadata" in state
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return _strip_module(state), port


def load_torch_file(path: str) -> dict[str, torch.Tensor]:
    """A torch or safetensors checkpoint's state_dict (``state_dict`` inside a
    Lightning or port file), ``module.`` stripped."""
    return _read_torch_file(path)[0]


def connext_reference_state_dict(sd: Mapping, model: nn.Module, path: str) -> dict:
    """A reference ConNexT state dict (``core/convert.py::connext_from_reference``)
    for ``model``'s head, tower variant, BERT depth and expert count; a name the
    JAX converter reads and the file lacks raises ValueError, as the JAX
    Trainer's ``_import_full_torch`` raises it."""
    from . import convert

    cfg = model.cfg
    try:
        return convert.connext_from_reference(sd, head=cfg.head, convnext_variant=cfg.convnext_variant,
                                              num_bert_layers=cfg.bert.num_hidden_layers,
                                              moe_num_experts=cfg.moe_num_experts,
                                              use_mamba_fusion=cfg.use_mamba_fusion)
    except KeyError as exc:
        raise ValueError(f"{path} does not look like a ConNexT Model4AAAI_MoE state dict for the 'connext' "
                         f"family (missing key {exc})") from exc


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
    sd, port = _read_torch_file(path)
    if family == "connext" and not port:
        return connext_reference_state_dict(sd, model, path)
    return sd


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


class TopKCheckpointManager:
    """Keeps the k best checkpoints of a run by a scalar metric (higher is better)."""

    def __init__(self, output_dir: str, k: int = 3, prefix: str = "epoch"):
        self.output_dir, self.k, self.prefix = output_dir, k, prefix
        self.entries: list[tuple[float, str]] = []  # (metric, path), best first
        os.makedirs(output_dir, exist_ok=True)
        # a resume into the same run directory reloads the index, so that retention goes on
        # evicting across restarts and best_path() sees the saves made before
        idx = os.path.join(output_dir, "checkpoints.json")
        if os.path.exists(idx):
            try:
                with open(idx) as f:
                    for e in json.load(f):
                        p = os.path.join(output_dir, e["path"])
                        if os.path.exists(p):
                            self.entries.append((float(e["metric"]), p))
                self.entries.sort(key=lambda e: e[0], reverse=True)
            except (ValueError, KeyError, TypeError) as exc:  # TypeError: a null metric, a non-list document
                log.warning("ignoring unreadable checkpoints.json: %s", exc)

    def maybe_save(self, epoch: int, metric: float, state: Mapping) -> Optional[str]:
        """Save ``state`` when ``metric`` is among the k best so far, evicting the worst; its path."""
        if len(self.entries) >= self.k and not metric > min(e[0] for e in self.entries):
            return None
        path = os.path.join(self.output_dir, f"{self.prefix}_{epoch}_val_acc_{metric:.2f}{CHECKPOINT_EXT}")
        save_state(path, state)
        while len(self.entries) >= self.k:
            worst = min(self.entries, key=lambda e: e[0])
            if os.path.exists(worst[1]):
                os.remove(worst[1])
            self.entries.remove(worst)
        self.entries.append((metric, path))
        self.entries.sort(key=lambda e: e[0], reverse=True)
        self._write_index()
        return path

    def save_last(self, state: Mapping) -> str:
        path = os.path.join(self.output_dir, "last" + CHECKPOINT_EXT)
        save_state(path, state)
        return path

    def best_path(self) -> Optional[str]:
        return self.entries[0][1] if self.entries else None

    def _write_index(self) -> None:
        index = [{"metric": m, "path": os.path.basename(p)} for m, p in self.entries]
        path = os.path.join(self.output_dir, "checkpoints.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f, indent=2)
        os.replace(tmp, path)
