"""Serving runtime for a live model of either family.

Counterpart of ``mdhs_tpu/serving.py::ServingModel`` for an ``nn.Module``
(the exported-artifact loader is ROADMAP item 9): MIBF-Net (served by its
``image_text`` head, images not normalised), the baseline family (its
logits, ImageNet-normalised images) or ConNexT (the logits of its (logits,
balance loss) pair, ImageNet-normalised images). The model says which
through its ``normalize_input`` attribute and its ``input_dtype`` (its image
tower's dtype: a bf16 baseline holds float32 parameters too). A serving
process:

  - keeps the weights resident on the device;
  - runs a fixed static batch: a partial batch is zero-padded and the
    logits are sliced back;
  - ships requests as uint8 canvases (1 byte a pixel) and does the eval
    preprocessing on the device (``ops/preprocess.py::eval_pipeline``);
  - with ``tta`` (a tuple of ``ops/tta.py``'s transforms), runs the original
    and the variants as one batch and averages their logits; with
    ``ablation_mode`` (the baseline family's ``image_only`` / ``text_off``),
    passes it to the forward;
  - in ``predict_stream``, keeps up to ``depth`` requests in flight: the
    host copies each request into a pinned buffer, the host-to-device copy
    is ``non_blocking`` on the compute stream, the logits come back into a
    pinned buffer, and the host waits only on the event of the request it
    fetches.

A request is a dict of numpy arrays: ``image`` uint8 ``(n, H, W, 3)``,
``input_ids`` and ``attention_mask`` ``(n, L)``, with ``n <= batch_size``.

``MIBF_HAM_SERVING`` is the int8 serving preset of
``configs/serving/mibf_ham_serving.yml``, ``HAM_FUSION_SSM`` and
``HAM_HEAD_MOE`` the baseline configurations of
``configs/ham/ham_fusion_ssm_v1.yml`` and ``ham_head_moe_v1.yml``, and
``CONNEXT_HAM`` the ConNexT configuration of
``configs/connext/connext_ham.yml``, resolved (the card's machine has no
yaml reader; tests hold each equal to its YAML).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .models.baseline import BaselineConfig
from .models.bert import BertConfig
from .models.connext import ConNexTConfig
from .ops.preprocess import eval_pipeline
from .ops.tta import tta_logits


@dataclasses.dataclass(frozen=True)
class ServingPreset:
    """A serving configuration: the text tower, the static batch, the
    tokenizer length and the label count."""

    bert: BertConfig
    batch_size: int
    seq_len: int
    num_labels: int


# configs/serving/mibf_ham_serving.yml over configs/mibf/mibf_ham.yml:
# model.fast_math true, model.text_encoder.quantize int8 (BERT-base preset),
# inference.batch_size 512, tokenizer.max_length 256, model.num_classes 7.
MIBF_HAM_SERVING = ServingPreset(
    bert=BertConfig(fast_math=True, quantize="int8"), batch_size=512, seq_len=256, num_labels=7,
)

# configs/ham/ham_fusion_ssm_v1.yml and ham_head_moe_v1.yml over configs/common/base.yml
# (BaselineConfig.from_config + bert_config_from: BERT-base, hidden 256, dropout 0.3,
# 7 classes); batch 64 (training.batch_size), seq 128 (tokenizer.max_length).
HAM_FUSION_SSM = BaselineConfig(dropout=0.3, fusion_type="mamba", classifier_type="mlp")
HAM_HEAD_MOE = BaselineConfig(dropout=0.3, fusion_type="multiscale", classifier_type="moe")
BASELINE_BATCH, BASELINE_SEQ = 64, 128

# configs/connext/connext_ham.yml over configs/common/base.yml (the JAX Trainer's
# build_model for family "connext"): ConvNeXt-base, BERT-base, fusion 768, the MoE head
# (model.moe.enabled) of 4 KAN experts [768, 512, 128, 32, 7], top-2, 7 classes; batch 32
# (training.batch_size, the batch run_predict takes), seq 512 (tokenizer.max_length),
# canvas 256 cropped to 224 (data.canvas, data.image_size). model.moe.balance_weight
# weighs the returned balance loss in training, on top of the MoE's own 1e-2 coefficient.
CONNEXT_HAM = ConNexTConfig(head="moe", moe_num_experts=4, moe_k=2)
CONNEXT_BATCH, CONNEXT_SEQ, CONNEXT_CANVAS, CONNEXT_CROP = 32, 512, 256, 224
CONNEXT_BALANCE_WEIGHT = 0.01

_INPUTS = {"image": torch.uint8, "input_ids": torch.int64, "attention_mask": torch.int64}


class ServingModel:
    def __init__(self, model: nn.Module, batch_size: int, device: str | torch.device = "cuda",
                 image_size: int = 224, tta: Sequence[str] = (), ablation_mode: Optional[str] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.image_size = int(image_size)
        self.model = model.to(device=self.device, memory_format=torch.channels_last).eval()
        self.dtype = model.input_dtype
        self.normalize = model.normalize_input
        self.tta = tuple(tta)
        self.forward_kwargs = {} if ablation_mode is None else {"ablation_mode": ablation_mode}
        self._slots: list[dict] = []  # host staging buffers, one per in-flight request

    def _logits(self, images, input_ids, attention_mask) -> torch.Tensor:
        """The model's float32 logits of a preprocessed batch."""
        logits = self.model(images, input_ids, attention_mask, **self.forward_kwargs)
        if isinstance(logits, dict):  # MIBF-Net's three heads
            return logits["image_text"]
        if isinstance(logits, tuple):  # ConNexT's (logits, balance loss)
            return logits[0]
        return logits

    # ------------------------------------------------------------------
    def _slot(self, i: int, batch: dict) -> dict:
        """Host buffers of ring slot ``i``, made at the first request's shapes."""
        while len(self._slots) <= i:
            pin = self.device.type == "cuda"
            bufs = {k: torch.zeros((self.batch_size,) + np.shape(batch[k])[1:], dtype=dt, pin_memory=pin)
                    for k, dt in _INPUTS.items()}
            self._slots.append(bufs)
        return self._slots[i]

    def _dispatch(self, batch: dict, slot: int):
        """Stage one request and enqueue its forward; returns (logits handle, n)."""
        n = int(np.shape(batch["image"])[0])
        if not 1 <= n <= self.batch_size:
            raise ValueError(f"request of {n} rows; the static batch is {self.batch_size}")
        bufs = self._slot(slot, batch)
        for k, buf in bufs.items():
            if k not in batch:
                raise KeyError(f"serving request missing input {k!r}")
            v = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if tuple(v.shape[1:]) != tuple(buf.shape[1:]):
                raise ValueError(f"input {k!r} has shape {tuple(v.shape)}, expected (n,) + {tuple(buf.shape[1:])}")
            buf[:n].copy_(v)
            buf[n:].zero_()
        with torch.inference_mode():
            dev = {k: buf.to(self.device, non_blocking=True) for k, buf in bufs.items()}
            images = eval_pipeline(dev["image"], self.image_size, normalize=self.normalize, dtype=self.dtype)
            if self.tta:
                logits = tta_logits(self._logits, images, dev["input_ids"], dev["attention_mask"],
                                    transforms=self.tta)
            else:
                logits = self._logits(images, dev["input_ids"], dev["attention_mask"])
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
