"""Serving runtime: a live model of any family, or an exported artifact.

Counterpart of ``mdhs_tpu/serving.py::ServingModel``. ``ServeFunction`` is
the served step, (uint8 image, input_ids, attention_mask[, tabular]) ->
float32 logits:
the eval preprocessing on the device (``ops/preprocess.py::eval_pipeline``),
with ``tta`` (a tuple of ``ops/tta.py``'s transforms) the original and the
variants as one batch with their logits averaged, and the family's logits:
MIBF-Net's ``image_text`` head (images not normalised), the baseline family's
logits (ImageNet-normalised images; ``ablation_mode``, its ``image_only`` /
``text_off``, passed to the forward) or ConNexT's (the logits of its (logits,
balance loss) pair, ImageNet-normalised). The model says which through its
``normalize_input`` attribute and its ``input_dtype`` (its image tower's
dtype: a bf16 baseline holds float32 parameters too).

``ServingModel`` runs a ``ServeFunction``: made around a live ``nn.Module``
(``ServingModel(model, batch_size, ...)``), or loaded from an artifact that
``cli/export_serving.py`` wrote by exporting that same module with
``torch.export`` (``ServingModel.load(path)``), so the two cannot drift. The
loader imports the port's op registrations (``mdhs_tpu_torch.ops``) and no
model code. A serving process:

  - keeps the weights resident on the device;
  - runs a fixed static batch: a partial batch is zero-padded and the
    logits are sliced back;
  - ships requests as uint8 canvases (1 byte a pixel) and does the eval
    preprocessing on the device;
  - in ``predict_stream``, keeps up to ``depth`` requests in flight: the
    host copies each request into a pinned buffer, the host-to-device copy
    is ``non_blocking`` on the compute stream, the logits come back into a
    pinned buffer, and the host waits only on the event of the request it
    fetches.

A request is a dict of numpy arrays: ``image`` uint8 ``(n, H, W, 3)`` (a live
baseline with a sequence encoder also takes ``(n, T, H, W, 3)``),
``input_ids`` and ``attention_mask`` ``(n, L)``, with ``n <= batch_size``,
and for a baseline with the tabular branch ``tabular`` float32 ``(n,
width)``. An artifact takes what its ``meta.json`` lists.

The artifact is one file, ``torch.export.save``'s archive of the exported
program (the weights inside it, the int8 weights and the stacked MoE bank as
constants made once before the trace) with a ``meta.json`` beside it in the
archive: the format tag ``FORMAT``, the device type it was exported for, the
family, the static batch, the input spec, the TTA transforms.
"""

from __future__ import annotations

import json
import zipfile
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import ops  # noqa: F401  (registers the torch.ops.mdhs kernels an artifact calls)
from .device import resolve_device
from .ops.preprocess import eval_pipeline
from .ops.tta import tta_logits

FORMAT = "mdhs-serving-torch-v1"
META = "meta.json"

_INPUTS = {"image": torch.uint8, "input_ids": torch.int64, "attention_mask": torch.int64}


def model_inputs(model: nn.Module) -> dict:
    """{name: dtype} of the inputs the served step of ``model`` takes: the image
    and the tokens, and ``tabular`` for a baseline with the tabular branch."""
    cfg = getattr(model, "cfg", None)
    return {**_INPUTS, "tabular": torch.float32} if getattr(cfg, "tabular_enabled", False) else dict(_INPUTS)


class ServeFunction(nn.Module):
    """The served step of ``model``: ``forward(image, input_ids, attention_mask,
    tabular=None)`` takes the uint8 canvases ``(B, H, W, 3)`` (or a 5-D stack),
    the tokens ``(B, L)`` and, for the tabular branch, the float32 records on the
    device and returns the float32 logits ``(B, labels)``. A model without the
    branch ignores ``tabular``, as JAX's eval step does (an artifact of such a
    model exported from a config with ``model.tabular`` on takes the input)."""

    def __init__(self, model: nn.Module, image_size: int = 224, tta: Sequence[str] = (),
                 ablation_mode: Optional[str] = None):
        super().__init__()
        self.model = model
        self.image_size = int(image_size)
        self.normalize = model.normalize_input
        self.dtype = model.input_dtype
        self.tta = tuple(tta)
        self.forward_kwargs = {} if ablation_mode is None else {"ablation_mode": ablation_mode}
        self.takes_tabular = "tabular" in model_inputs(model)

    def _logits(self, images, input_ids, attention_mask, tabular=None) -> torch.Tensor:
        """The model's float32 logits of a preprocessed batch."""
        kwargs = {**self.forward_kwargs, "tabular": tabular} if self.takes_tabular else self.forward_kwargs
        logits = self.model(images, input_ids, attention_mask, **kwargs)
        if isinstance(logits, dict):  # MIBF-Net's three heads
            return logits["image_text"]
        if isinstance(logits, tuple):  # ConNexT's (logits, balance loss)
            return logits[0]
        return logits

    def forward(self, image: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                tabular: Optional[torch.Tensor] = None) -> torch.Tensor:
        images = eval_pipeline(image, self.image_size, normalize=self.normalize, dtype=self.dtype)
        if self.tta:
            return tta_logits(self._logits, images, input_ids, attention_mask, tabular, transforms=self.tta)
        return self._logits(images, input_ids, attention_mask, tabular)


def read_meta(path: str) -> dict:
    """The artifact's ``meta.json``, checked to carry this package's format tag."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: not a serving artifact (not a torch.export archive)")
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.endswith(f"/extra/{META}")]
        if len(names) != 1:
            raise ValueError(f"{path}: not a serving artifact (no {META} in the archive)")
        meta = json.loads(z.read(names[0]))
    if meta.get("format") != FORMAT:
        raise ValueError(f"unsupported serving artifact format {meta.get('format')!r} (expected {FORMAT!r})")
    return meta


class ServingModel:
    def __init__(self, model: nn.Module, batch_size: int, device: str | torch.device = "cuda",
                 image_size: int = 224, tta: Sequence[str] = (), ablation_mode: Optional[str] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.model = model.to(device=self.device, memory_format=torch.channels_last).eval()
        self.fn = ServeFunction(self.model, image_size, tta, ablation_mode)
        self.dtype, self.normalize, self.tta = self.fn.dtype, self.fn.normalize, self.fn.tta
        self.inputs = model_inputs(self.model)
        self.input_spec: Optional[dict] = None  # a live model takes the first request's shapes
        self._slots: list[dict] = []  # host staging buffers, one per in-flight request

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "ServingModel":
        """Serve the artifact at ``path`` (``cli/export_serving.py``) with no
        model code. Refuses another format, and an artifact exported for
        another device type than ``device``'s."""
        meta = read_meta(path)
        dev = resolve_device(device)
        if dev.type != meta["device"]:
            raise ValueError(f"{path} was exported for {meta['device']!r} and cannot run on {dev.type!r}: "
                             f"export it again with --device {dev.type}")
        self = cls.__new__(cls)
        self.device, self.batch_size = dev, int(meta["batch_size"])
        self.fn = torch.export.load(path).module()
        self.model = None
        self.dtype, self.normalize = getattr(torch, meta["image_dtype"]), bool(meta["normalize"])
        self.tta = tuple(meta["tta"])
        self.input_spec = {k: (tuple(shape), dtype) for k, (shape, dtype) in meta["inputs"].items()}
        self.inputs = {k: getattr(torch, dtype) for k, (_, dtype) in self.input_spec.items()}
        self.meta = meta
        self._slots = []
        return self

    # ------------------------------------------------------------------
    def _slot(self, i: int, batch: dict) -> dict:
        """Host buffers of ring slot ``i``, made at the artifact's input spec or,
        for a live model, at the first request's shapes."""
        while len(self._slots) <= i:
            pin = self.device.type == "cuda"
            shape = ((lambda k: self.input_spec[k][0]) if self.input_spec else
                     (lambda k: (self.batch_size,) + np.shape(batch[k])[1:]))
            self._slots.append({k: torch.zeros(shape(k), dtype=dt, pin_memory=pin) for k, dt in self.inputs.items()})
        return self._slots[i]

    def _dispatch(self, batch: dict, slot: int):
        """Stage one request and enqueue its forward; returns (logits handle, n)."""
        n = int(np.shape(batch["image"])[0])
        if not 1 <= n <= self.batch_size:
            raise ValueError(f"request of {n} rows; the static batch is {self.batch_size}")
        for k in self.inputs:
            if k not in batch:
                raise KeyError(f"serving request missing input {k!r}")
        bufs = self._slot(slot, batch)
        for k, buf in bufs.items():
            v = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if tuple(v.shape[1:]) != tuple(buf.shape[1:]):
                raise ValueError(f"input {k!r} has shape {tuple(v.shape)}, expected (n,) + {tuple(buf.shape[1:])}")
            buf[:n].copy_(v)
            buf[n:].zero_()
        with torch.inference_mode():
            dev = [bufs[k].to(self.device, non_blocking=True) for k in self.inputs]
            logits = self.fn(*dev)
            if self.device.type != "cuda":
                return logits, n
            host = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
            host.copy_(logits, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return (host, done), n

    def _fetch(self, handle, n: int) -> np.ndarray:
        if self.device.type != "cuda":
            return handle[:n].numpy().copy()
        host, done = handle
        done.synchronize()
        return host[:n].numpy().copy()

    # ------------------------------------------------------------------
    def predict(self, batch: dict) -> np.ndarray:
        """Synchronous call: the logits of the request's rows."""
        handle, n = self._dispatch(batch, 0)
        return self._fetch(handle, n)

    def predict_stream(self, batches, depth: int = 2):
        """Pipelined loop: yields the logits of each request, in order.

        Request k+1 is staged and enqueued while request k computes; with
        ``depth`` requests in flight, ring slot j % (depth + 1) is reused only
        after request j - depth - 1 has been fetched, so its host buffers are
        free. ``depth=0`` is the synchronous loop.
        """
        depth = max(int(depth), 0)
        inflight = deque()
        for j, batch in enumerate(batches):
            inflight.append(self._dispatch(batch, j % (depth + 1)))
            while len(inflight) > depth:
                yield self._fetch(*inflight.popleft())
        while inflight:
            yield self._fetch(*inflight.popleft())
