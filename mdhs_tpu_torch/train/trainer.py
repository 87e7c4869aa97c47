"""MIBF-Net training on one device.

Counterpart of ``mdhs_tpu/train/trainer.py::Trainer`` for ``family="mibf"``:
``train_step`` is its ``train_step_fn`` (:654-691), ``validate`` its
validation step and loop (:752-813), ``fit`` its epoch loop (:1216-1289).
A step takes a host batch of numpy arrays as ``mdhs_tpu/data/loader.py``
yields it (``image`` uint8 (B, S, S, 3), ``input_ids``, ``attention_mask``,
``label``, optional ``n_valid``), copies it to the device through pinned
staging buffers, augments on the device (``ops/augment.py``: crop, flips, the
3-shear rotation through the ``shear_sublane`` kernel), runs the forward in
training mode, MP-Loss with the ``n_valid`` row mask, the backward, the
optimizer update and the BatchNorm running-statistics update. Loss and
accuracy stay on the device until a logging point reads them.

Mixed precision, as the JAX package's flax modules (``dtype=bf16``, float32
parameters) have it: the working module computes in bf16, and the optimizer
updates float32 master copies of its weights, which are copied back into the
module after each step. BatchNorm keeps float32 weight, bias and running
statistics inside the bf16 module (a momentum-0.1 update in bf16 would lose
most of its digits), and cuDNN takes bf16 activations with float32 BatchNorm
parameters. ``torch.autocast`` is not used: it would leave BERT's residual
stream in float32, and the eval kernels of ``validate`` want bf16.

Dropout draws from torch's default generators, which the trainer seeds from
``training.seed``; the JAX package draws its masks from another PRNG
(``trainer.py:655-662`` records that no parity surface depends on which).
The augmentation draws from a ``torch.Generator`` on the device, seeded from
the same seed.

``MIBF_HAM_TRAIN`` is ``configs/mibf/mibf_ham.yml`` over
``configs/common/base.yml``, resolved through the JAX Trainer's MIBF defaults
(the card's machine has no yaml reader; a test holds the two equal).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.bert import BertConfig
from ..models.init import init_parameters
from ..models.mibf import MIBFNet
from ..ops.augment import CropFlipRotate, train_pipeline
from ..ops.preprocess import eval_pipeline
from .losses import mibf_loss
from .metrics import correct_count, masked_accuracy
from .optim import make_optimizer, make_schedule, set_learning_rate

log = logging.getLogger(__name__)

_PRECISIONS = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
               "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainPreset:
    """A resolved training configuration: the fields the trainer reads. The
    JAX Trainer's other options (other families, host augmentation, colour
    jitter, stain normalisation, supcon, remat, KAN re-gridding, meshes,
    checkpoints, freezing, the flattened optimizer) have no field here: the
    port trains none of them yet (ROADMAP Queue 1 items 8-12)."""

    bert: BertConfig
    num_labels: int
    batch_size: int
    seq_len: int
    canvas: int
    image_size: int
    learning_rate: float
    num_epochs: int
    optimizer: str
    lr_scheduler: Optional[str]
    warmup_epochs: int
    weight_decay: float
    loss_class: str
    degrees: float
    vflip: bool
    precision: str
    seed: int


# configs/mibf/mibf_ham.yml over configs/common/base.yml: 7 labels, batch 32,
# lr 2e-5, 30 epochs, Adam, cosine, KL_loss, tokenizer length 256, canvas 256
# -> crop 224, bf16, seed 0, warmup_epochs 3 (base.yml); the Trainer's MIBF
# defaults: degrees 15, no vflip, no colour jitter, no Normalize.
MIBF_HAM_TRAIN = TrainPreset(
    bert=BertConfig(), num_labels=7, batch_size=32, seq_len=256, canvas=256, image_size=224,
    learning_rate=2e-5, num_epochs=30, optimizer="Adam", lr_scheduler="cosine", warmup_epochs=3,
    weight_decay=0.01, loss_class="KL_loss", degrees=15.0, vflip=False, precision="bf16",
    seed=0,
)

_INPUTS = {"image": torch.uint8, "input_ids": torch.int64, "attention_mask": torch.int64,
           "label": torch.int64}


def _split_precision(model: nn.Module, dtype: torch.dtype) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Cast every parameter outside BatchNorm to ``dtype`` in place; return
    (working parameter, float32 master) pairs, the master being the parameter
    itself where nothing was cast."""
    pairs = []
    for m in model.modules():
        for p in m.parameters(recurse=False):
            if isinstance(m, nn.BatchNorm2d) or p.dtype == dtype:
                pairs.append((p, p))
                continue
            master = p.detach().float().requires_grad_()  # the weights as they came, float32
            p.data = master.detach().to(dtype)
            pairs.append((p, master))
    return pairs


class Trainer:
    """MIBF-Net training: ``train_step``, ``validate`` and ``fit``.

    ``model`` is a float32 ``MIBFNet`` whose weights become the masters
    (seeded random weights from ``training.seed`` when it is None). The device
    defaults to "cuda" and raises where there is none.
    """

    def __init__(self, preset: TrainPreset = MIBF_HAM_TRAIN, *, model: Optional[MIBFNet] = None,
                 device: str | torch.device = "cuda", steps_per_epoch: int = 1):
        if preset.precision.lower() not in _PRECISIONS:
            raise ValueError(f"precision={preset.precision!r}: expected one of {sorted(_PRECISIONS)}")
        self.preset = preset
        self.device = resolve_device(device)
        self.dtype = _PRECISIONS[preset.precision.lower()]
        torch.manual_seed(preset.seed)  # dropout masks come from torch's default generators
        self.generator = torch.Generator(device=self.device).manual_seed(preset.seed)
        if model is None:
            model = init_parameters(MIBFNet(preset.num_labels, preset.bert, device=self.device),
                                    torch.Generator(device=self.device).manual_seed(preset.seed))
        model = model.to(self.device)
        self._pairs = _split_precision(model, self.dtype)
        self.model = model.to(memory_format=torch.channels_last).train()
        self._casts = [(p, m) for p, m in self._pairs if p is not m]
        for _, m in self._casts:
            m.grad = torch.zeros_like(m)
        self.optimizer = make_optimizer(preset.optimizer, [m for _, m in self._pairs],
                                        preset.learning_rate, preset.weight_decay)
        self.set_steps_per_epoch(steps_per_epoch)
        self.step = 0
        self._staging = [{"bufs": {}, "copied": None} for _ in range(2)]
        self._n_staged = 0

    def set_steps_per_epoch(self, steps_per_epoch: int) -> None:
        """The schedule's epoch length (the JAX Trainer takes it from its loader)."""
        p = self.preset
        self.steps_per_epoch = max(1, int(steps_per_epoch))
        self.lr_schedule = make_schedule(p.lr_scheduler, p.learning_rate, num_epochs=p.num_epochs,
                                         steps_per_epoch=self.steps_per_epoch, warmup_epochs=p.warmup_epochs)

    def master_parameters(self) -> list[torch.Tensor]:
        """The float32 weights the optimizer updates, in ``model.parameters()`` order."""
        return [m for _, m in self._pairs]

    # ------------------------------------------------------------------
    def to_device(self, batch: dict) -> dict:
        """Host batch -> device tensors. On the card each array goes through a
        pinned buffer and a non-blocking copy on the current stream; a ring of
        two buffer sets is reused once the copies out of it have run."""
        if self.device.type != "cuda":
            return {k: torch.as_tensor(np.asarray(batch[k])).to(dt) for k, dt in _INPUTS.items()}
        slot = self._staging[self._n_staged % len(self._staging)]
        self._n_staged += 1
        if slot["copied"] is not None:
            slot["copied"].synchronize()
        out = {}
        for k, dt in _INPUTS.items():
            v = torch.from_numpy(np.ascontiguousarray(batch[k]))
            buf = slot["bufs"].get(k)
            if buf is None or buf.shape != v.shape:
                with torch.inference_mode(False):  # made in validate, the buffer is still written by train steps
                    buf = slot["bufs"][k] = torch.empty(v.shape, dtype=dt, pin_memory=True)
            buf.copy_(v)
            out[k] = buf.to(self.device, non_blocking=True)
        slot["copied"] = torch.cuda.Event()
        slot["copied"].record()
        return out

    def valid_mask(self, batch: dict, n_rows: int) -> Optional[torch.Tensor]:
        """0/1 rows from the loader's n_valid: a short last batch's padded rows
        stay out of the loss, the gradients and the metrics (they still pass
        through the forward, so training-mode BatchNorm sees them)."""
        nv = batch.get("n_valid")
        if nv is None:
            return None
        return (torch.arange(n_rows, device=self.device) < int(nv)).float()

    def augment(self, images_uint8: torch.Tensor, params: Optional[CropFlipRotate] = None) -> torch.Tensor:
        """The training augmentation on the device; ``params`` replaces the draw."""
        p = self.preset
        return train_pipeline(images_uint8, self.generator, p.image_size, degrees=p.degrees, vflip=p.vflip,
                              dtype=self.dtype, params=params)

    def forward_backward(self, images: torch.Tensor, dev: dict, valid: Optional[torch.Tensor] = None):
        """Training-mode forward, the loss, and its gradients into the working
        module; returns (loss, logits of the three heads), both detached."""
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        out = self.model(images, dev["input_ids"], dev["attention_mask"])
        loss = mibf_loss(out, dev["label"], self.preset.loss_class, sample_mask=valid)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in out.items()}

    def optimizer_step(self) -> None:
        """One update of the float32 masters at the schedule's rate for the
        updates made so far, then the copy back into the working module."""
        for p, _ in self._pairs:
            if p.grad is None:  # as optax, a parameter the loss does not reach gets a zero gradient
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            if self._casts:
                torch._foreach_copy_([m.grad for _, m in self._casts], [p.grad for p, _ in self._casts])
            set_learning_rate(self.optimizer, self.lr_schedule(self.step))
            self.optimizer.step()
            if self._casts:
                torch._foreach_copy_([p for p, _ in self._casts], [m for _, m in self._casts])
        self.step += 1

    def train_step(self, batch: dict) -> dict:
        """One step on a host batch; returns on-device ``loss`` and ``accuracy``."""
        dev = self.to_device(batch)
        valid = self.valid_mask(batch, dev["label"].shape[0])
        images = self.augment(dev["image"])
        loss, out = self.forward_backward(images, dev, valid)
        self.optimizer_step()
        return {"loss": loss, "accuracy": masked_accuracy(out["image_text"], dev["label"], valid)}

    # ------------------------------------------------------------------
    def validate(self, batches: Iterable[dict]) -> tuple[float, float]:
        """Eval preprocessing (MIBF's: no Normalize), the training criterion (the whole MP-Loss) and
        masked accuracy over ``batches``: (mean loss a batch, accuracy in %)."""
        p = self.preset
        self.model.eval()
        total_loss = torch.zeros((), device=self.device)
        correct = torch.zeros((), device=self.device)
        total, n_batches = 0, 0
        with torch.inference_mode():
            for batch in batches:
                dev = self.to_device(batch)
                n = dev["label"].shape[0]
                valid = self.valid_mask(batch, n)
                images = eval_pipeline(dev["image"], p.image_size, normalize=False, dtype=self.dtype)
                out = self.model(images, dev["input_ids"], dev["attention_mask"])
                total_loss += mibf_loss(out, dev["label"], p.loss_class, sample_mask=valid)
                correct += correct_count(out["image_text"], dev["label"], valid)
                total += int(batch.get("n_valid", n))
                n_batches += 1
        self.model.train()
        return total_loss.item() / max(1, n_batches), 100.0 * correct.item() / max(1, total)

    def fit(self, train_batches: Iterable[dict], val_batches: Optional[Iterable[dict]] = None,
            num_epochs: Optional[int] = None, steps_per_epoch: Optional[int] = None) -> list[dict]:
        """Epoch loop: up to ``steps_per_epoch`` steps from ``train_batches``
        (iterated anew each epoch), then ``validate(val_batches)``. Losses stay
        on the device until the epoch ends. Returns one record an epoch."""
        if steps_per_epoch is None:
            steps_per_epoch = len(train_batches)
        self.set_steps_per_epoch(steps_per_epoch)
        history = []
        for epoch in range(num_epochs or self.preset.num_epochs):
            t0 = time.perf_counter()
            losses = [self.train_step(b)["loss"] for b in itertools.islice(train_batches, steps_per_epoch)]
            train_losses = torch.stack(losses).tolist() if losses else []
            val_loss, val_acc = self.validate(val_batches) if val_batches is not None else (0.0, 0.0)
            rec = {"epoch": epoch + 1, "steps": self.step, "train_losses": train_losses,
                   "train_loss": float(np.mean(train_losses)) if train_losses else 0.0,
                   "val_loss": val_loss, "val_acc": val_acc, "lr": self.lr_schedule(self.step),
                   "seconds": time.perf_counter() - t0}
            log.info("Epoch %d -> Train Loss: %.4f, Val Loss: %.4f, Val Acc: %.2f%% (%.1fs)",
                     rec["epoch"], rec["train_loss"], val_loss, val_acc, rec["seconds"])
            history.append(rec)
        return history
