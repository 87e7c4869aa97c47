"""Training on one device: MIBF-Net and ConNexT, from a config or a preset.

Counterpart of ``mdhs_tpu/train/trainer.py::Trainer`` for the ``mibf`` and
``connext`` families: the constructor (:167-297: loaders, class weights, the
schedule over ``len(train_loader)``, the run directory, metric writer and
top-3 checkpoints, pretrained towers, ``training.resume_from``),
``train_step`` (its ``train_step_fn``, :654-691), ``validate`` and
``log_validation_report`` (:752-846) and ``fit`` (:1216-1289). The baseline
family raises (ROADMAP Queue 1 item 10).

A step takes a host batch of numpy arrays as ``data/loader.py`` yields it
(``image`` uint8 (B, S, S, 3), ``input_ids``, ``attention_mask``, ``label``,
optional ``n_valid``), copies it to the device through pinned staging
buffers, augments on the device (``ops/augment.py``: crop, flips, the 3-shear
rotation through the ``shear_sublane`` kernel; for ConNexT colour jitter and
ImageNet normalisation too), runs the training forward, the family's loss
with the ``n_valid`` row mask (MIBF: MP-Loss, ``model.loss_class``; ConNexT:
cross-entropy with the class weights, no smoothing, plus
``model.moe.balance_weight`` times the MoE's balance loss), the backward, the
optimizer update and the BatchNorm running-statistics update. Loss and
accuracy stay on the device until a logging point reads them.

Mixed precision, as the JAX package's flax modules (``dtype=bf16``, float32
parameters) have it: the working module computes in bf16, and the optimizer
updates float32 master copies of its weights, which are copied back into the
module after each step. BatchNorm, the KAN layers and the MoE gate keep
float32 parameters inside the bf16 module, as the served models do (a
momentum-0.1 update in bf16 would lose most of its digits; the KAN kernel is
float32). ``torch.autocast`` is not used: it would leave BERT's residual
stream in float32, and the eval kernels of ``validate`` want bf16.

Random streams: dropout draws from torch's default generators, which the
trainer seeds from ``training.seed``; the augmentation and the MoE's gating
noise each from a ``torch.Generator`` of their own on the device, seeded
from the same seed. The JAX package draws from other PRNGs
(``trainer.py:655-662`` records that no parity surface depends on which), so
parity tests hand both packages the same augmentation values and gating
noise. ``last.pt`` keeps all of their states, the loader's shuffle, the step,
the float32 masters and the optimizer state, so that a run resumed from it
(``training.resume_from``) goes on with the schedule and the streams where
they stopped; the JAX Trainer's resume reloads the weights only.

Deviations from the JAX Trainer, each named where it applies: the run
directory holds ``config.json`` (``Config.save_json``) where JAX writes
``config.yml``, since a machine may have no yaml writer; checkpoints are the
port's ``torch.save`` files (``core/checkpoint.py``); ``training.profile``
writes a ``torch.profiler`` trace; ``training.flatten_optimizer`` is accepted
and changes nothing, as it changes no math in JAX (``optim.py:283-290``).

``MIBF_HAM_TRAIN`` is ``configs/mibf/mibf_ham.yml`` over
``configs/common/base.yml``, resolved through the JAX Trainer's MIBF defaults
(the card's machine has no yaml reader; a test holds the two equal).
``Trainer(preset)`` trains such a preset on batches the caller gives, with
no run directory; ``Trainer(cfg, family)`` is the config-driven path that
``cli/run_train.py`` takes.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import (TopKCheckpointManager, host_state_dict, is_flax_msgpack, load_state_dict_file,
                               merge_tolerant)
from ..core.config import Config
from ..core.pretrained import load_pretrained
from ..data.datasets import DatasetOptions, MultimodalDataset
from ..data.loader import DataLoader
from ..data.tokenizer import load_tokenizer
from ..device import resolve_device
from ..models import FAMILIES, build_model
from ..models.bert import BertConfig
from ..models.init import init_parameters
from ..models.mibf import MIBFNet
from ..modules.kan import KANLinear
from ..modules.moe import MoE
from ..ops.augment import ColorJitter, CropFlipRotate, train_pipeline
from ..ops.preprocess import eval_pipeline
from ..utils.logging import MetricWriter, setup_logging, setup_run_dir
from .losses import compute_class_weights, cross_entropy, mibf_loss
from .metrics import classification_report, correct_count, masked_accuracy
from .optim import make_optimizer, make_schedule, set_learning_rate

log = logging.getLogger(__name__)

_PRECISIONS = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
               "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32}
TRAINED_FAMILIES = ("mibf", "connext")


@dataclasses.dataclass(frozen=True)
class TrainPreset:
    """A resolved training configuration: the numbers the trainer reads.
    ``family`` "mibf" takes MP-Loss (``loss_class``) and no jitter or
    normalisation; "connext" cross-entropy plus ``balance_weight`` times the
    MoE balance loss, colour jitter and ImageNet normalisation."""

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
    family: str = "mibf"
    color_jitter: bool = False
    normalize: bool = False
    balance_weight: float = 0.01


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


def preset_from_config(cfg: Config, family: str, bert: BertConfig) -> TrainPreset:
    """The JAX Trainer's reads of a config (``trainer.py:167-262``) for ``family``."""
    t = cfg.get("training", {})
    aug = cfg.get("data.augment", {}) or {}
    mibf = family == "mibf"
    return TrainPreset(
        bert=bert, num_labels=int(cfg.get("model.num_classes", 6 if mibf else 7)),
        batch_size=int(t.get("batch_size", 32)), seq_len=int(cfg.get("tokenizer.max_length", 128)),
        canvas=int(cfg.get("data.canvas", 256)), image_size=int(cfg.get("data.image_size", 224)),
        learning_rate=float(t.get("learning_rate", 1e-4)), num_epochs=int(t.get("num_epochs", 1)),
        optimizer=str(t.get("optimizer", "Adam")), lr_scheduler=t.get("lr_scheduler"),
        warmup_epochs=t.get("warmup_epochs", 5), weight_decay=float(t.get("weight_decay", 0.01)),
        loss_class=cfg.get("model.loss_class", "KL_loss"),
        degrees=float(aug.get("degrees", 15.0 if mibf else 45.0)), vflip=bool(aug.get("vflip", not mibf)),
        precision=str(t.get("precision", "bf16") or "bf16"), seed=int(t.get("seed", 0)), family=family,
        color_jitter=bool(aug.get("color_jitter", not mibf)), normalize=not mibf,
        balance_weight=float(cfg.get("model.moe.balance_weight", 0.01)),
    )


def check_trainable(cfg: Config, family: str) -> None:
    """Raise for what the port does not train yet, before anything is built."""
    if family == "baseline":
        raise NotImplementedError("training the baseline family is not ported yet: ROADMAP Queue 1 item 10")
    if family not in FAMILIES:
        raise ValueError(f"unknown model family: {family}")
    if (cfg.get("data.stain_normalization", {}) or {}).get("enabled", False):
        raise NotImplementedError("data.stain_normalization is not ported yet: ROADMAP Queue 1 item 10")
    if (cfg.get("data.augment", {}) or {}).get("host", False):
        raise NotImplementedError("data.augment.host (the host augmentation) is not ported yet: "
                                  "ROADMAP Queue 1 item 8")
    if int(cfg.get("training.kan_update_grid_every", 0) or 0) > 0:
        raise NotImplementedError("training.kan_update_grid_every (KAN re-gridding) is not ported yet: "
                                  "ROADMAP Queue 1 item 10")
    if int(cfg.get("parallel.n_model", 1)) > 1:
        raise NotImplementedError("parallel.n_model > 1 is not ported yet: ROADMAP Queue 1 item 12")
    flatten = cfg.get("training.flatten_optimizer", False)
    if flatten not in (False, True, "bucketed"):
        raise ValueError(f"training.flatten_optimizer must be false, true, or 'bucketed'; got {flatten!r}")


_INPUTS = {"image": torch.uint8, "input_ids": torch.int64, "attention_mask": torch.int64,
           "label": torch.int64}
_FLOAT32_MODULES = (nn.BatchNorm2d, KANLinear, MoE)  # float32 parameters inside a bf16 module


def _split_precision(model: nn.Module, dtype: torch.dtype) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Cast every parameter outside BatchNorm, the KAN layers and the MoE gate to
    ``dtype`` in place (and the KAN layers' and the MoE's output dtype to it, as
    in a module built in ``dtype``); return (working parameter, float32 master)
    pairs in ``model.parameters()`` order, the master being the parameter itself
    where nothing was cast."""
    pairs = []
    for m in model.modules():
        if isinstance(m, (KANLinear, MoE)):
            m.out_dtype = dtype
        for p in m.parameters(recurse=False):
            if isinstance(m, _FLOAT32_MODULES) or p.dtype == dtype:
                pairs.append((p, p))
                continue
            master = p.detach().float().requires_grad_()  # the weights as they came, float32
            p.data = master.detach().to(dtype)
            pairs.append((p, master))
    return pairs


class Trainer:
    """Training of the ``mibf`` and ``connext`` families: ``train_step``,
    ``validate`` and ``fit``.

    ``Trainer(cfg, family, output_dir=None, device="cuda", setup_data=True)``
    builds the family's model from a ``Config`` (seeded random weights, then
    the config's pretrained weights and ``training.resume_from``), its train
    and val loaders, the run directory, metric writer and checkpoints.
    ``Trainer(preset, model=None, device="cuda", steps_per_epoch=1)`` takes a
    ``TrainPreset`` and a float32 model (seeded random MIBF-Net weights where
    it is None), and batches from the caller. The device defaults to "cuda"
    and raises where there is none.
    """

    def __init__(self, cfg: Config | TrainPreset = MIBF_HAM_TRAIN, family: Optional[str] = None,
                 output_dir: Optional[str] = None, device: str | torch.device = "cuda", setup_data: bool = True,
                 *, model: Optional[nn.Module] = None, steps_per_epoch: int = 1):
        self.train_loader = self.val_loader = None
        self.writer = self.ckpt = None
        self.class_weights = None
        self.output_dir = output_dir
        if isinstance(cfg, TrainPreset):
            self.cfg, preset = None, cfg
            if family is not None and family != preset.family:
                raise ValueError(f"family {family!r} against the preset's {preset.family!r}")
            self.family = preset.family
            self.device = resolve_device(device)
        else:
            self.cfg, self.family = cfg, family or "baseline"
            check_trainable(cfg, self.family)
            self.device = resolve_device(device)  # a missing card raises before anything is read
            self.tokenizer = load_tokenizer(cfg.get("model.text_encoder.model_name"),
                                            vocab_size=cfg.get("model.text_encoder.vocab_size", 30522))
            if setup_data:
                self.train_loader = self._make_loader("train")
                self.val_loader = self._make_loader("val")
            if model is None:
                model = init_parameters(build_model(cfg, self.family, self.tokenizer, device=self.device,
                                                    dtype=torch.float32),
                                        torch.Generator(device=self.device).manual_seed(int(cfg.get("training.seed", 0))))
            preset = preset_from_config(cfg, self.family, model.text_encoder.bert.cfg)
            if cfg.get("training.class_weight") == "balanced" and self.train_loader is not None:
                self.class_weights = torch.from_numpy(
                    compute_class_weights(self.train_loader.dataset.labels, preset.num_labels)).to(self.device)
            if self.train_loader is not None:
                steps_per_epoch = len(self.train_loader)
        if preset.precision.lower() not in _PRECISIONS:
            raise ValueError(f"precision={preset.precision!r}: expected one of {sorted(_PRECISIONS)}")
        if preset.family not in TRAINED_FAMILIES:
            raise NotImplementedError(f"training family {preset.family!r}: ROADMAP Queue 1 item 10")
        self.preset = preset
        self.dtype = _PRECISIONS[preset.precision.lower()]
        torch.manual_seed(preset.seed)  # dropout masks come from torch's default generators
        self.generator = torch.Generator(device=self.device).manual_seed(preset.seed)
        self.gating_generator = torch.Generator(device=self.device).manual_seed(preset.seed + 1)
        if model is None:
            model = init_parameters(MIBFNet(preset.num_labels, preset.bert, device=self.device),
                                    torch.Generator(device=self.device).manual_seed(preset.seed))
        model = model.to(self.device)
        resume = None
        if self.cfg is not None:
            # weights named in the config load into the float32 model, before the masters are made
            load_pretrained(model, self.cfg, self.family)
            resume = self.cfg.get("training.resume_from")
            if resume:
                self.load_weights(resume, model)
        self._pairs = _split_precision(model, self.dtype)
        self.model = model.to(memory_format=torch.channels_last).train()
        names = [n for n, _ in self.model.named_parameters()]
        self._master_by_name = {n: m for n, (_, m) in zip(names, self._pairs)}
        self._casts = [(p, m) for p, m in self._pairs if p is not m]
        self._freeze()
        for p, m in self._casts:
            if m.requires_grad:
                m.grad = torch.zeros_like(m)
        self.optimizer = make_optimizer(preset.optimizer, [m for p, m in self._pairs if p.requires_grad],
                                        preset.learning_rate, preset.weight_decay)
        self.set_steps_per_epoch(steps_per_epoch)
        self.step = self.epoch = 0
        self._best_val, self._es_bad = -float("inf"), 0
        self._staging = [{"bufs": {}, "copied": None} for _ in range(2)]
        self._n_staged = 0
        if self.cfg is not None:
            self._setup_run()
            if resume:
                self._restore(resume)

    # ------------------------------------------------------------------ set-up
    def _make_loader(self, split: str) -> Optional[DataLoader]:
        """``trainer.py:299-343``: the split's dataset through the port's data path; the
        train split shuffled (or class-weighted by ``training.sampler: weighted``) from the seed."""
        cfg = self.cfg
        d = cfg.get("data")
        image_dir = d.get(f"{split}_image_dir")
        if image_dir is None:
            return None
        opts = DatasetOptions(
            max_length=cfg.get("tokenizer.max_length", 128),
            tabular_enabled=bool(cfg.get("model.tabular.enabled", False)),
            extra_image_dirs=tuple(d.get("extra_image_dirs", []) or []),
            pseudo_2p5d=bool(d.get("pseudo_2p5d.enabled", False)),
            sequence=bool(d.get("sequence.enabled", False)),
            multi_view=bool(d.get("multi_view.enabled", False)),
            clean_cjk_text=self.family == "mibf",
            canvas=int(cfg.get("data.canvas", 256)),
            llm_hidden_json=d.get(f"{split}_llm_hidden_json") or d.get("llm_hidden_json"),
            cache=bool(d.get("cache", True)),
        )
        ds = MultimodalDataset(image_dir, d.get(f"{split}_json_path"), d.get(f"{split}_label_csv"), self.tokenizer,
                               opts)
        is_train = split == "train"
        return DataLoader(ds, batch_size=int(cfg.get("training.batch_size", 32)), shuffle=is_train,
                          weighted=is_train and cfg.get("training.sampler") == "weighted",
                          num_classes=cfg.get("model.num_classes", 7), seed=int(cfg.get("training.seed", 0)))

    def _freeze(self) -> None:
        """``model.image_encoder.freeze`` / ``model.text_encoder.freeze``
        (``trainer.py:147-164``, ``optim.py:275-320``): a frozen tower's parameters
        take no gradient, no update and no weight decay."""
        frozen = [tower for tower in ("image_encoder", "text_encoder")
                  if self.cfg is not None and self.cfg.get(f"model.{tower}.freeze", False)]
        for name, p in self.model.named_parameters():
            if name.split(".")[0] in frozen:
                p.requires_grad_(False)
                self._master_by_name[name].requires_grad_(False)

    def _setup_run(self) -> None:
        """The run directory (``{output.log_dir}/{output.run_name}_{timestamp}`` where
        none is given), ``training.log``, ``config.json``, the metric writer and
        the top-3 checkpoints."""
        cfg = self.cfg
        if self.output_dir is None:
            self.output_dir = setup_run_dir(cfg.get("output.log_dir", "./runs"), cfg.get("output.run_name", "run"))
        os.makedirs(self.output_dir, exist_ok=True)
        setup_logging(self.output_dir)
        cfg.save_json(os.path.join(self.output_dir, "config.json"))
        self.writer = MetricWriter(self.output_dir)
        self.ckpt = TopKCheckpointManager(self.output_dir, k=3)
        n = sum(p.numel() for p in self.model.parameters())
        log.info("initialized %s model: %.2fM params", self.family, n / 1e6)

    def set_steps_per_epoch(self, steps_per_epoch: int) -> None:
        """The schedule's epoch length (the JAX Trainer takes it from its loader)."""
        p = self.preset
        self.steps_per_epoch = max(1, int(steps_per_epoch))
        self.lr_schedule = make_schedule(p.lr_scheduler, p.learning_rate, num_epochs=p.num_epochs,
                                         steps_per_epoch=self.steps_per_epoch, warmup_epochs=p.warmup_epochs)

    def master_parameters(self) -> list[torch.Tensor]:
        """The float32 weights the optimizer updates, in ``model.parameters()`` order."""
        return [m for _, m in self._pairs]

    # ------------------------------------------------------------------ weights and checkpoints
    def state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state dict with each parameter's float32 master in its place."""
        return {k: self._master_by_name.get(k, v) for k, v in self.model.state_dict().items()}

    def checkpoint_state(self) -> dict:
        """A checkpoint's contents: the float32 state dict on the CPU and its metadata."""
        return {"state_dict": host_state_dict(self.state_dict()),
                "metadata": {"family": self.family, "epoch": self.epoch, "step": self.step}}

    def _resume_state(self) -> dict:
        rng = {"torch": torch.get_rng_state(), "augment": self.generator.get_state(),
               "gating": self.gating_generator.get_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        loader = self.train_loader._rng.bit_generator.state if self.train_loader is not None else None
        return {"epoch": self.epoch, "step": self.step, "optimizer": self.optimizer.state_dict(), "rng": rng,
                "loader": loader, "best_val": self._best_val, "es_bad": self._es_bad}

    def last_state(self) -> dict:
        """``last.pt``'s contents: a checkpoint and what a resume needs under ``resume``."""
        return {**self.checkpoint_state(), "resume": self._resume_state()}

    def load_weights(self, path: str, model: Optional[nn.Module] = None) -> None:
        """Load any checkpoint ``core/checkpoint.py`` reads (a port file, a JAX
        msgpack, a reference torch state dict) into the model tolerantly, and
        into the masters where they exist."""
        model = model if model is not None else self.model
        loaded = load_state_dict_file(path, self.family, model)
        if model is getattr(self, "model", None):
            target = self.state_dict()
            merged = merge_tolerant(target, loaded)
            with torch.no_grad():
                for k, v in merged.items():
                    if v is not target[k]:
                        target[k].copy_(v)
                self._sync_working()
        else:
            merged = merge_tolerant(model.state_dict(), loaded)
            model.load_state_dict(merged, strict=True)
        log.info("loaded weights from %s", path)

    def _sync_working(self) -> None:
        if self._casts:
            torch._foreach_copy_([p for p, _ in self._casts], [m for _, m in self._casts])

    def _restore(self, path: str) -> None:
        """Step, epoch, optimizer, generators and the loader's shuffle from ``last.pt``
        (the weights were loaded before the masters were made). A file without
        them (a best checkpoint, a JAX or reference file) gave its weights only."""
        state = {} if is_flax_msgpack(path) else torch.load(path, map_location="cpu", weights_only=True)
        r = state.get("resume") if isinstance(state, dict) else None
        if r is None:
            return
        self.optimizer.load_state_dict(r["optimizer"])
        self.step, self.epoch = int(r["step"]), int(r["epoch"])
        self._best_val, self._es_bad = float(r["best_val"]), int(r["es_bad"])
        torch.set_rng_state(r["rng"]["torch"])
        self.generator.set_state(r["rng"]["augment"])
        self.gating_generator.set_state(r["rng"]["gating"])
        if "cuda" in r["rng"] and self.device.type == "cuda":
            torch.cuda.set_rng_state(r["rng"]["cuda"], self.device)
        if r["loader"] is not None and self.train_loader is not None:
            self.train_loader._rng.bit_generator.state = r["loader"]
        log.info("resumed from %s at epoch %d, step %d", path, self.epoch, self.step)

    # ------------------------------------------------------------------ the step
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
        through the forward, so training-mode BatchNorm and the MoE balance loss
        see them)."""
        nv = batch.get("n_valid")
        if nv is None:
            return None
        return (torch.arange(n_rows, device=self.device) < int(nv)).float()

    def augment(self, images_uint8: torch.Tensor, params: Optional[CropFlipRotate] = None,
                jitter: Optional[ColorJitter] = None) -> torch.Tensor:
        """The training augmentation on the device; ``params`` and ``jitter`` replace the draws."""
        p = self.preset
        return train_pipeline(images_uint8, self.generator, p.image_size, degrees=p.degrees, vflip=p.vflip,
                              dtype=self.dtype, params=params, color_jitter=p.color_jitter, jitter=jitter,
                              normalize=p.normalize)

    def criterion(self, out, labels: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The family's loss (``trainer.py:550-567``): MIBF's MP-Loss family on its
        three heads; ConNexT's cross-entropy with the class weights and no smoothing."""
        if self.family == "mibf":
            return mibf_loss(out, labels, self.preset.loss_class, sample_mask=valid)
        return cross_entropy(out, labels, class_weights=self.class_weights, sample_mask=valid)

    def _forward(self, images, dev, train: bool, noise=None):
        """(what the criterion takes, the joint logits, the balance loss or None)."""
        if self.family == "mibf":
            out = self.model(images, dev["input_ids"], dev["attention_mask"])
            return out, out["image_text"], None
        logits, balance = self.model(images, dev["input_ids"], dev["attention_mask"], train=train,
                                     generator=self.gating_generator if train else None, noise=noise)
        return logits, logits, balance

    def forward_backward(self, images: torch.Tensor, dev: dict, valid: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None):
        """Training-mode forward, the loss, and its gradients into the working
        module; returns (loss, outputs), both detached: MIBF's three heads, or
        ConNexT's ``logits`` and ``balance``. ``noise`` replaces ConNexT's gating draw."""
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        out, logits, balance = self._forward(images, dev, True, noise)
        loss = self.criterion(out, dev["label"], valid)
        if balance is not None:
            loss = loss + self.preset.balance_weight * balance
        loss.backward()
        if balance is None:
            return loss.detach(), {k: v.detach() for k, v in out.items()}
        return loss.detach(), {"logits": logits.detach(), "balance": balance.detach()}

    def optimizer_step(self) -> None:
        """One update of the float32 masters at the schedule's rate for the
        updates made so far, then the copy back into the working module."""
        for p, _ in self._pairs:
            if p.grad is None and p.requires_grad:  # as optax, a parameter the loss does not reach: a zero gradient
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            live = [(p, m) for p, m in self._casts if p.requires_grad]
            if live:
                torch._foreach_copy_([m.grad for _, m in live], [p.grad for p, _ in live])
            set_learning_rate(self.optimizer, self.lr_schedule(self.step))
            self.optimizer.step()
            self._sync_working()
        self.step += 1

    def train_step(self, batch: dict) -> dict:
        """One step on a host batch; returns on-device ``loss`` and ``accuracy``."""
        dev = self.to_device(batch)
        valid = self.valid_mask(batch, dev["label"].shape[0])
        images = self.augment(dev["image"])
        loss, out = self.forward_backward(images, dev, valid)
        self.optimizer_step()
        logits = out["image_text"] if self.family == "mibf" else out["logits"]
        return {"loss": loss, "accuracy": masked_accuracy(logits, dev["label"], valid)}

    # ------------------------------------------------------------------ validation
    def _val_pass(self, batches: Iterable[dict], keep_logits: bool):
        p = self.preset
        self.model.eval()
        total_loss = torch.zeros((), device=self.device)
        correct = torch.zeros((), device=self.device)
        total, n_batches, kept = 0, 0, []
        with torch.inference_mode():
            for batch in batches:
                dev = self.to_device(batch)
                n = dev["label"].shape[0]
                valid = self.valid_mask(batch, n)
                images = eval_pipeline(dev["image"], p.image_size, normalize=p.normalize, dtype=self.dtype)
                out, logits, _ = self._forward(images, dev, False)
                total_loss += self.criterion(out, dev["label"], valid)
                correct += correct_count(logits, dev["label"], valid)
                nv = int(batch.get("n_valid", n))
                total += nv
                n_batches += 1
                if keep_logits:
                    kept.append((logits[:nv].float(), dev["label"][:nv]))
        self.model.train()
        return total_loss.item() / max(1, n_batches), 100.0 * correct.item() / max(1, total), kept

    def validate(self, batches: Optional[Iterable[dict]] = None) -> tuple[float, float]:
        """Eval preprocessing (ImageNet normalisation but for MIBF), the training
        criterion (MIBF: the whole MP-Loss; no balance loss) and masked accuracy
        over ``batches`` (the val loader's by default): (mean loss a batch, accuracy in %)."""
        batches = self.val_loader if batches is None else batches
        if batches is None:
            return 0.0, 0.0
        loss, acc, _ = self._val_pass(batches, False)
        return loss, acc

    def log_validation_report(self, epoch: int, batches: Optional[Iterable[dict]] = None):
        """Macro and per-class precision / recall / F1 and AUROC over the val split,
        under JAX's tags (``val/{metric}``, ``per_class/{metric}_{class name}``)."""
        batches = self.val_loader if batches is None else batches
        if batches is None:
            return None
        return self._write_report(self._val_pass(batches, True)[2], epoch)

    def _write_report(self, kept: list, epoch: int) -> dict:
        logits = torch.cat([k[0] for k in kept])
        labels = torch.cat([k[1] for k in kept])
        n_cls = self.preset.num_labels
        rep = classification_report(logits, labels, n_cls)
        names = (self.cfg.get("data.class_names") if self.cfg is not None else None) or \
            [f"class_{i}" for i in range(n_cls)]
        for tag in ("accuracy_macro", "precision_macro", "recall_macro", "f1_macro", "auroc_macro"):
            self.writer.scalar(f"val/{tag}", float(rep[tag]), epoch)
        for metric, values in rep["per_class"].items():
            for i, v in enumerate(values.tolist()):
                self.writer.scalar(f"per_class/{metric}_{names[i]}", v, epoch)
        return rep

    # ------------------------------------------------------------------ the epoch loop
    def _opt(self, key: str, default):
        return self.cfg.get(key, default) if self.cfg is not None else default

    def fit(self, train_batches: Optional[Iterable[dict]] = None, val_batches: Optional[Iterable[dict]] = None,
            num_epochs: Optional[int] = None, steps_per_epoch: Optional[int] = None) -> list[dict]:
        """Epochs from ``self.epoch`` (past a resume's) up to ``num_epochs``
        (``training.num_epochs``): up to ``steps_per_epoch`` steps from
        ``train_batches`` (the train loader's by default, iterated anew each
        epoch), then ``validate(val_batches)``. Losses stay on the device until
        the epoch ends. Where the trainer has a run directory it writes JAX's
        scalars (``Loss/Train_Batch`` every ``training.log_every`` steps;
        ``Loss/Train_Epoch``, ``Loss/Validation``, ``Accuracy/Validation``,
        ``LearningRate`` each epoch; the per-class report under
        ``training.log_per_class``), offers each epoch to the top-3
        checkpoints, saves ``last.pt``, and stops early under
        ``training.early_stopping``. Returns one record an epoch."""
        train_batches = self.train_loader if train_batches is None else train_batches
        val_batches = self.val_loader if val_batches is None else val_batches
        if steps_per_epoch is None:
            steps_per_epoch = len(train_batches)
        if steps_per_epoch != self.steps_per_epoch:
            self.set_steps_per_epoch(steps_per_epoch)
        num_epochs = num_epochs or self.preset.num_epochs
        log_every = int(self._opt("training.log_every", 100))
        per_class = bool(self._opt("training.log_per_class", False)) and self.writer is not None
        es_cfg = self._opt("training.early_stopping", {}) or {}
        es_patience = int(es_cfg.get("patience", 0)) if es_cfg.get("enabled") else 0
        prof_cfg = self._opt("training.profile", {}) or {}
        prof_steps = int(prof_cfg.get("steps", 20)) if prof_cfg.get("enabled") and self.output_dir else 0
        prof = self._start_profile() if prof_steps else None
        history = []
        for epoch in range(self.epoch, num_epochs):
            t0 = time.perf_counter()
            losses, n_steps = [], 0
            for batch in itertools.islice(train_batches, steps_per_epoch):
                m = self.train_step(batch)
                losses.append(m["loss"])
                n_steps += 1
                if prof is not None and n_steps == prof_steps:
                    prof = self._stop_profile(prof)
                if self.writer is not None and self.step % log_every == 0:
                    self.writer.scalar("Loss/Train_Batch", float(m["loss"]), self.step)
            train_losses = torch.stack(losses).tolist() if losses else []
            val_loss, val_acc, kept = self._val_pass(val_batches, per_class) if val_batches is not None \
                else (0.0, 0.0, [])
            self.epoch = epoch + 1
            if per_class:
                self._write_report(kept, self.epoch)
            lr = self.lr_schedule(self.step)
            rec = {"epoch": self.epoch, "steps": self.step, "train_losses": train_losses,
                   "train_loss": float(np.mean(train_losses)) if train_losses else 0.0,
                   "val_loss": val_loss, "val_acc": val_acc, "lr": lr, "seconds": time.perf_counter() - t0}
            log.info("Epoch %d/%d -> Train Loss: %.4f, Val Loss: %.4f, Val Acc: %.2f%% (%.1fs)", self.epoch,
                     num_epochs, rec["train_loss"], val_loss, val_acc, rec["seconds"])
            history.append(rec)
            if self.writer is not None:
                for tag, value in (("Loss/Train_Epoch", rec["train_loss"]), ("Loss/Validation", val_loss),
                                   ("Accuracy/Validation", val_acc), ("LearningRate", lr)):
                    self.writer.scalar(tag, value, self.epoch)
            stop = False
            if es_patience:
                if val_acc > self._best_val + float(es_cfg.get("min_delta", 0.0)):
                    self._best_val, self._es_bad = val_acc, 0
                else:
                    self._es_bad += 1
                    stop = self._es_bad >= es_patience
            if self.ckpt is not None:
                saved = self.ckpt.maybe_save(self.epoch, val_acc, self.checkpoint_state())
                if saved:
                    log.info("  -> saved checkpoint: %s", os.path.basename(saved))
                self.ckpt.save_last(self.last_state())
            if stop:
                log.info("early stopping at epoch %d (patience %d)", self.epoch, es_patience)
                break
        if prof is not None:
            self._stop_profile(prof)
        if self.writer is not None:
            self.writer.close()
        return history

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof) -> None:
        """``training.profile``: the first ``steps`` steps' trace as ``profile/trace.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = os.path.join(self.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        log.info("profiler trace written to %s", out)
        return None
