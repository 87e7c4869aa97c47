"""Training on one device: the baseline family, MIBF-Net and ConNexT, from a
config or a preset.

Counterpart of ``mdhs_tpu/train/trainer.py::Trainer``: the constructor
(:167-297: loaders, class weights, the loss configuration, the schedule over
``len(train_loader)``, the run directory, metric writer and top-3
checkpoints, pretrained towers, ``training.resume_from``), ``train_step``
(its ``train_step_fn`` and ``_loss_fn``, :594-691), ``validate`` and
``log_validation_report`` (:752-846), the KAN re-gridding ``_kan_regrid``
(:856-952) and ``fit`` (:1216-1289). ``check_trainable`` raises, before
anything is built, for what is not ported yet, naming its ROADMAP item.

A step takes a host batch of numpy arrays as ``data/loader.py`` yields it
(``image`` uint8 (B, S, S, 3), or (B, T, S, S, 3) for the sequence and
multi-view modes, ``input_ids``, ``attention_mask``, ``label``, optional
``tabular`` float32 (B, width), ``first_hidden`` and ``last_hidden`` float32
(B, llm_hidden_dim), which ConNexT's Mamba fusion reads, and ``n_valid``), copies it to the device
through pinned staging buffers, augments on the device (a 5-D stack as one
B * T batch with one draw, as ``trainer.py:407-456``) (``ops/augment.py``: crop, flips, the 3-shear
rotation through the ``shear_sublane`` kernel; for the baseline and ConNexT
colour jitter and ImageNet normalisation too; ``data.stain_normalization``
before the crop, ``ops/stain_norm.py``), runs the training forward, the
family's loss with the ``n_valid`` row mask (MIBF: MP-Loss,
``model.loss_class``; ConNexT: cross-entropy with the class weights, no
smoothing; the baseline: ``training.loss`` (``ce`` with its label smoothing
or ``focal``) with the class weights, and the supervised contrastive loss of
``training.supcon``, which replaces it in the ``pretrain`` stage and is added
times ``weight`` in ``finetune``; for the MoE heads of both, plus
``model.moe.balance_weight`` times the balance loss), the backward, the
optimizer update and the BatchNorm running-statistics update. Loss and
accuracy stay on the device until a logging point reads them.

Mixed precision, as the JAX package's flax modules (``dtype=bf16``, float32
parameters) have it: the working module computes in bf16, and the optimizer
updates float32 master copies of its weights, which are copied back into the
module after each step. BatchNorm, the KAN layers and the MoE gate keep
float32 parameters inside the bf16 module, as the served models do (a
momentum-0.1 update in bf16 would lose most of its digits; the KAN kernel is
float32), and so do the GroupKAN activations' coefficients, Mamba's
``dt_bias``, ``A_log`` and ``D``, the weighted-concat fusion's ``w_img`` and
``w_txt`` and the hierarchical fusion's ``scale_weights``, which the JAX
modules use in float32 arithmetic. ``torch.autocast`` is not used: it would
leave BERT's residual stream in float32, and the eval kernels of
``validate`` want bf16.

Random streams: dropout draws from torch's default generators, which the
trainer seeds from ``training.seed``; the augmentation and the MoE's gating
noise each from a ``torch.Generator`` of their own on the device, seeded
from the same seed. The JAX package draws from other PRNGs
(``trainer.py:655-662`` records that no parity surface depends on which), so
parity tests hand both packages the same augmentation values and gating
noise. ``last.pt`` keeps all of their states, the loader's shuffle, the step,
the float32 masters, the optimizer state and the run's configuration, so that
a run resumed from it (``training.resume_from``) goes on with the schedule
and the streams where they stopped. A ``last.pt`` written under another
configuration (the SupCon recipe's stage 1 for its stage 2,
``configs/ham/ham_supcon_stage2_v1.yml``) gives its weights only, with a
fresh schedule and optimizer, as the JAX Trainer's resume always does
(:294-296). Which keys make a run its own: ``RUN_KEYS``.

KAN re-gridding (``training.kan_update_grid_every``) runs every that many
steps on the step's batch: one eval-mode forward captures each KAN layer's
input (a forward hook on each ``KANLinear``; for an MoE bank, the inputs of
each of its layers, per expert), and ``modules/kan.py::kan_update_grid``
refits each layer's grid and spline weights on the host, as JAX does;
the float32 weights are written in place, so the masters, the optimizer
state and ``MoE.stacked_layers``' kept stack follow.

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
import json
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
from ..data.datasets import DatasetOptions, MultimodalDataset, tabular_dim
from ..data.loader import DataLoader
from ..data.tokenizer import load_tokenizer
from ..device import resolve_device
from ..models import FAMILIES, build_model, model_config
from ..models.bert import BertConfig
from ..models.init import init_parameters
from ..models.mibf import MIBFNet
from ..modules.kan import GroupKANLinear, KANLinear, kan_update_grid
from ..modules.moe import MoE
from ..ops.augment import ColorJitter, CropFlipRotate, train_pipeline
from ..ops.preprocess import eval_pipeline
from ..utils.logging import MetricWriter, setup_logging, setup_run_dir
from .losses import LOSSES, compute_class_weights, cross_entropy, mibf_loss, supcon_loss
from .metrics import classification_report, correct_count, masked_accuracy
from .optim import make_optimizer, make_schedule, set_learning_rate

log = logging.getLogger(__name__)

_PRECISIONS = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
               "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32}
TRAINED_FAMILIES = ("baseline", "mibf", "connext")


@dataclasses.dataclass(frozen=True)
class TrainPreset:
    """A resolved training configuration: the numbers the trainer reads.
    ``family`` "mibf" takes MP-Loss (``loss_class``) and no jitter or
    normalisation; "connext" cross-entropy plus ``balance_weight`` times the
    MoE balance loss, colour jitter and ImageNet normalisation; "baseline"
    ``loss_type`` ("ce" with ``label_smoothing``, or "focal" with
    ``focal_gamma``), the SupCon loss in ``supcon_stage`` ("pretrain",
    "finetune" or None), the MoE head's balance loss, jitter and
    normalisation. ``stain`` is (target mean, target std) of the stain
    normalisation, or None."""

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
    loss_type: str = "ce"
    label_smoothing: float = 0.02
    focal_gamma: float = 2.0
    supcon_stage: Optional[str] = None
    supcon_temperature: float = 0.07
    supcon_weight: float = 0.1
    stain: Optional[tuple] = None
    ablation_mode: Optional[str] = None


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
    loss = t.get("loss", {}) or {}
    sc = t.get("supcon", {}) or {}
    stain = cfg.get("data.stain_normalization", {}) or {}
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
        loss_type=str(loss.get("type", "ce")).lower(), label_smoothing=float(loss.get("label_smoothing", 0.02)),
        focal_gamma=float(loss.get("focal_gamma", 2.0)),
        supcon_stage=str(sc.get("stage", "finetune")) if sc.get("enabled", False) else None,
        supcon_temperature=float(sc.get("temperature", 0.07)), supcon_weight=float(sc.get("weight", 0.1)),
        stain=(tuple(map(float, stain.get("target_mean", (150.0, 140.0, 140.0)))),
               tuple(map(float, stain.get("target_std", (20.0, 20.0, 20.0))))) if stain.get("enabled") else None,
        ablation_mode=cfg.get("model.ablation_mode") if family == "baseline" else None,
    )


def check_trainable(cfg: Config, family: str) -> None:
    """Raise for what the port does not train yet, before anything is built:
    the host augmentation (the dataset's own check too), Muon, ``parallel.n_model`` > 1, and for the baseline family the model's
    own check (``remat``), each naming its ROADMAP item; and
    a stacked data mode (multi-view, sequence) for a family without a sequence
    encoder, whose towers take 4-D images."""
    if family not in FAMILIES:
        raise ValueError(f"unknown model family: {family}")
    if (cfg.get("data.augment", {}) or {}).get("host", False):
        raise NotImplementedError("data.augment.host (the host augmentation) is not ported yet: "
                                  "ROADMAP Queue 1 item 8")
    if str(cfg.get("training.optimizer", "Adam")).lower() == "muon":
        raise NotImplementedError("the Muon optimizer is not ported yet: ROADMAP Queue 1 item 8")
    if int(cfg.get("parallel.n_model", 1)) > 1:
        raise NotImplementedError("parallel.n_model > 1 is not ported yet: ROADMAP Queue 1 item 12")
    if cfg.get("data") is not None:
        opts = DatasetOptions.from_config(cfg, family, "train")
        opts.check_ported()
        if family != "baseline" and (opts.multi_view or opts.sequence):
            raise ValueError("data.multi_view and data.sequence make (B, T, ...) image stacks, which only the "
                             f"baseline family's sequence encoder takes, not {family!r}")
    if family == "baseline":
        model_config(cfg, family, 30522).check_ported()  # any vocabulary: the check reads none
    flatten = cfg.get("training.flatten_optimizer", False)
    if flatten not in (False, True, "bucketed"):
        raise ValueError(f"training.flatten_optimizer must be false, true, or 'bucketed'; got {flatten!r}")


_INPUTS = {"image": torch.uint8, "input_ids": torch.int64, "attention_mask": torch.int64,
           "label": torch.int64, "tabular": torch.float32, "first_hidden": torch.float32,
           "last_hidden": torch.float32}
# float32 parameters inside a bf16 module: every one of these modules' own, and those a module
# names in its ``float32_params`` (Mamba's dt_bias, A_log and D; the fusions' scalar weights)
_FLOAT32_MODULES = (nn.BatchNorm2d, KANLinear, MoE, GroupKANLinear)
# the configuration that makes a run its own: a last.pt written under another loads its weights only
RUN_KEYS = ("model", "training")
_RUN_KEYS_FREE = ("resume_from", "num_epochs", "log_every", "log_per_class", "profile", "early_stopping")


def _keeps_float32(m: nn.Module, name: str) -> bool:
    return isinstance(m, _FLOAT32_MODULES) or name in getattr(m, "float32_params", ())


def _split_precision(model: nn.Module, dtype: torch.dtype) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Cast every parameter outside BatchNorm, the KAN layers, the MoE gate, the
    GroupKAN activations and Mamba's float32 ones to ``dtype`` in place (and the
    KAN layers' and the MoE's output dtype to it, as in a module built in
    ``dtype``); return (working parameter, float32 master) pairs in
    ``model.parameters()`` order, the master being the parameter itself where
    nothing was cast."""
    pairs = []
    for m in model.modules():
        if isinstance(m, (KANLinear, MoE)):
            m.out_dtype = dtype
        for name, p in m.named_parameters(recurse=False):
            if _keeps_float32(m, name) or p.dtype == dtype:
                pairs.append((p, p))
                continue
            master = p.detach().float().requires_grad_()  # the weights as they came, float32
            p.data = master.detach().to(dtype)
            pairs.append((p, master))
    return pairs


class Trainer:
    """Training of the ``baseline``, ``mibf`` and ``connext`` families:
    ``train_step``, ``validate`` and ``fit``.

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
                # the tabular width from a loader's dataset, else from the metadata CSV (trainer.py:217-236)
                src = self.train_loader or self.val_loader
                width = src.dataset.tabular_dim if src is not None else tabular_dim(cfg)
                model = init_parameters(build_model(cfg, self.family, self.tokenizer, device=self.device,
                                                    dtype=torch.float32, tabular_dim=width),
                                        torch.Generator(device=self.device).manual_seed(int(cfg.get("training.seed", 0))))
            text = model.text_encoder
            preset = preset_from_config(cfg, self.family, (text.model if self.family == "baseline" else text.bert).cfg)
            if cfg.get("training.class_weight") == "balanced" and self.train_loader is not None:
                self.class_weights = torch.from_numpy(
                    compute_class_weights(self.train_loader.dataset.labels, preset.num_labels)).to(self.device)
            if self.train_loader is not None:
                steps_per_epoch = len(self.train_loader)
        if preset.precision.lower() not in _PRECISIONS:
            raise ValueError(f"precision={preset.precision!r}: expected one of {sorted(_PRECISIONS)}")
        if preset.family not in TRAINED_FAMILIES:
            raise ValueError(f"unknown training family {preset.family!r}")
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
        ds = MultimodalDataset(image_dir, d.get(f"{split}_json_path"), d.get(f"{split}_label_csv"), self.tokenizer,
                               DatasetOptions.from_config(cfg, self.family, split))
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
                "loader": loader, "best_val": self._best_val, "es_bad": self._es_bad, "run": self.run_identity()}

    def run_identity(self) -> Optional[str]:
        """The configuration that makes this run its own: ``RUN_KEYS`` with the
        keys a resume may change (``training.resume_from``, ``num_epochs``, the
        logging, profiling and early-stopping knobs) left out, and the family;
        None for a preset-driven trainer."""
        if self.cfg is None:
            return None
        d = self.cfg.to_dict()
        keep = {k: d.get(k) or {} for k in RUN_KEYS}
        keep["training"] = {k: v for k, v in keep["training"].items() if k not in _RUN_KEYS_FREE}
        return json.dumps({"family": self.family, **keep}, sort_keys=True, default=str)

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
        them (a best checkpoint, a JAX or reference file), or a ``last.pt`` of a
        run under another configuration (``run_identity``), gave its weights only:
        the schedule and the optimizer start afresh."""
        state = {} if is_flax_msgpack(path) else torch.load(path, map_location="cpu", weights_only=True)
        r = state.get("resume") if isinstance(state, dict) else None
        if r is None:
            return
        if r.get("run") is not None and r["run"] != self.run_identity():
            log.info("%s was written under another configuration: its weights only, a fresh schedule and "
                     "optimizer", path)
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
        keys = {k: dt for k, dt in _INPUTS.items() if k in batch}
        if self.device.type != "cuda":
            return {k: torch.as_tensor(np.asarray(batch[k])).to(dt) for k, dt in keys.items()}
        slot = self._staging[self._n_staged % len(self._staging)]
        self._n_staged += 1
        if slot["copied"] is not None:
            slot["copied"].synchronize()
        out = {}
        for k, dt in keys.items():
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
                              normalize=p.normalize, stain=p.stain)

    def criterion(self, out, labels: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The family's criterion, which validation uses too (``trainer.py:550-568``):
        MIBF's MP-Loss family on its three heads; ConNexT's cross-entropy with the
        class weights and no smoothing; the baseline's ``training.loss`` (focal, or
        cross-entropy with its label smoothing) with the class weights."""
        p = self.preset
        if self.family == "mibf":
            return mibf_loss(out, labels, p.loss_class, sample_mask=valid)
        if self.family == "connext":
            return cross_entropy(out, labels, class_weights=self.class_weights, sample_mask=valid)
        return LOSSES["focal" if p.loss_type == "focal" else "ce"](
            out, labels, label_smoothing=p.label_smoothing, gamma=p.focal_gamma, class_weights=self.class_weights,
            sample_mask=valid)

    def training_loss(self, out, feats, labels: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The criterion, or for the baseline under ``training.supcon`` (``trainer.py:608-615``)
        the SupCon loss of the fused feature in its place (``pretrain``) or added
        ``weight`` times (``finetune``)."""
        p = self.preset
        if feats is None or p.supcon_stage not in ("pretrain", "finetune"):
            return self.criterion(out, labels, valid)
        supcon = supcon_loss(feats, labels, p.supcon_temperature, sample_mask=valid)
        if p.supcon_stage == "pretrain":
            return supcon
        return self.criterion(out, labels, valid) + p.supcon_weight * supcon

    def _forward(self, images, dev, train: bool, noise=None):
        """(what the criterion takes, the joint logits, the balance loss or None,
        the baseline's fused feature in training or None)."""
        ids, mask, tab = dev["input_ids"], dev["attention_mask"], dev.get("tabular")
        if self.family == "mibf":
            out = self.model(images, ids, mask)
            return out, out["image_text"], None, None
        gen = self.gating_generator if train else None
        if self.family == "baseline":
            if not train:
                logits = self.model(images, ids, mask, self.preset.ablation_mode, tabular=tab)
                return logits, logits, None, None
            feats, logits, balance = self.model.features_and_logits(images, ids, mask, self.preset.ablation_mode,
                                                                    generator=gen, noise=noise, tabular=tab)
            return logits, logits, balance, feats
        logits, balance = self.model(images, ids, mask, train=train, generator=gen, noise=noise,
                                     first_hidden=dev.get("first_hidden"), last_hidden=dev.get("last_hidden"))
        return logits, logits, balance, None

    def forward_backward(self, images: torch.Tensor, dev: dict, valid: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None):
        """Training-mode forward, the loss, and its gradients into the working
        module; returns (loss, outputs), both detached: MIBF's three heads, or
        the ``logits`` and, with an MoE head, the ``balance`` loss. ``noise``
        replaces the MoE's gating draw."""
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        out, logits, balance, feats = self._forward(images, dev, True, noise)
        loss = self.training_loss(out, feats, dev["label"], valid)
        if balance is not None:
            loss = loss + self.preset.balance_weight * balance
        loss.backward()
        if self.family == "mibf":
            return loss.detach(), {k: v.detach() for k, v in out.items()}
        if balance is None:
            return loss.detach(), {"logits": logits.detach()}
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
                out, logits, _, _ = self._forward(images, dev, False)
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

    # ------------------------------------------------------------------ KAN re-gridding
    def _kan_inputs(self, batch: dict) -> dict:
        """One eval-mode forward of ``batch`` (eval preprocessing, clean gating, no
        gradients), capturing each KAN layer's float32 input: {KANLinear: (n, IN)}
        for the layers outside a bank (a forward pre-hook, as JAX's ``intermediates``
        sow them), {MoE: [each bank layer's input]} for the banks (``MoE.captured``)."""
        banks = [m for m in self.model.modules() if isinstance(m, MoE)]
        in_bank = {id(layer) for moe in banks for e in moe.experts for layer in e.layers}
        got: dict = {}

        def keep(mod, args):
            got[mod] = args[0].reshape(-1, mod.in_features).float()

        hooks = [m.register_forward_pre_hook(keep) for m in self.model.modules()
                 if isinstance(m, KANLinear) and id(m) not in in_bank]
        for moe in banks:
            moe.captured = got[moe] = []
        self.model.eval()
        try:
            with torch.inference_mode():
                dev = self.to_device(batch)
                images = eval_pipeline(dev["image"], self.preset.image_size, normalize=self.preset.normalize,
                                       dtype=self.dtype)
                self._forward(images, dev, False)
        finally:
            for h in hooks:
                h.remove()
            for moe in banks:
                moe.captured = None
            self.model.train()
        return got

    def _kan_regrid(self, batch: dict) -> int:
        """``trainer.py::_kan_regrid`` (:856-952): every KAN layer's grid moved toward
        its inputs on ``batch`` and its spline weights refit on the host
        (``modules/kan.py::kan_update_grid``), each expert of a bank on its own
        inputs; the float32 weights and grids written in place. Returns the number
        of layers re-gridded (a bank's layer counts once)."""
        if not any(isinstance(m, KANLinear) for m in self.model.modules()):
            return 0
        got = self._kan_inputs(batch)
        name_of = {p: n for n, p in self.model.named_parameters()}
        n = 0
        with torch.no_grad():
            for mod, x in got.items():
                if isinstance(mod, MoE):
                    for i, h in enumerate(x):
                        h = h.cpu().numpy()
                        for e, expert in enumerate(mod.experts):
                            self._regrid_layer(expert.layers[i], h[e] if h.ndim == 3 else h, name_of)
                else:
                    self._regrid_layer(mod, x.cpu().numpy(), name_of)
                n += len(x) if isinstance(mod, MoE) else 1
        log.info("re-gridded %d KAN layer(s)", n)
        return n

    def _regrid_layer(self, layer: KANLinear, x: np.ndarray, name_of: dict) -> None:
        new_sw, new_grid = kan_update_grid(x, layer.grid.cpu().numpy(), layer.spline_weight.detach().cpu().numpy(),
                                           layer.spline_scaler.detach().cpu().numpy(), grid_size=layer.grid_size,
                                           spline_order=layer.spline_order)
        master = self._master_by_name[name_of[layer.spline_weight]]  # the parameter itself: a float32 island
        master.copy_(torch.from_numpy(new_sw))
        if master is not layer.spline_weight:
            layer.spline_weight.copy_(master)
        layer.grid.copy_(torch.from_numpy(new_grid))

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
        ``training.early_stopping``. Every ``training.kan_update_grid_every``
        steps it re-grids the KAN layers on the step's batch. Returns one record
        an epoch."""
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
        regrid_every = int(self._opt("training.kan_update_grid_every", 0) or 0)
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
                if regrid_every and self.step % regrid_every == 0:
                    self._kan_regrid(batch)
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
