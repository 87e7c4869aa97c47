"""Shared plumbing of the CLIs: the trainer of a config; for eval, config, model and
weights, test loader, prediction loop.

Counterpart of ``mdhs_tpu/cli/common.py``. ``build_trainer`` is its
``build_trainer`` (:15-18) on ``train/trainer.py::Trainer``. ``Predictor`` takes the JAX
``Trainer``'s place for eval: ``build_model``, ``load_weights`` (any
checkpoint ``core/checkpoint.py`` reads), ``make_test_loader``
(``mdhs_tpu/train/trainer.py:345-373``: batches of ``training.batch_size``,
the CJK filter for MIBF only) and the eval step (:693-748), which is
``ServingModel``'s: a pinned host-to-device copy of the uint8 canvases, the
center crop (ImageNet normalisation for every family but MIBF), the
variants of TTA stacked on the batch when asked, the family's forward under
``torch.inference_mode`` (MIBF's ``image_text`` logits, the baseline with
its ``ablation_mode``, ConNexT's logits, with the test split's LLM hidden
vectors where its Mamba fusion reads them, tiled under TTA as
``trainer.py:726-729`` tiles them), the float32 logits back on the
host. ``run_prediction`` keeps the first ``n_valid`` rows of each batch.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from ..core.checkpoint import load_weights
from ..core.config import Config, load_config
from ..core.pretrained import load_pretrained
from ..data.datasets import DatasetOptions, MultimodalDataset, tabular_dim
from ..data.loader import DataLoader
from ..data.tokenizer import load_tokenizer
from ..device import resolve_device
from ..models import FAMILIES, build_model
from ..serving import ServingModel
from ..train.trainer import Trainer


class Predictor:
    """A family's model on ``device`` (default "cuda", raising where there is
    none) built from ``cfg``, with its test loader and eval step."""

    def __init__(self, cfg: Config, family: str = "baseline", device: str | torch.device = "cuda",
                 output_dir: Optional[str] = None):
        if family not in FAMILIES:
            raise ValueError(f"unknown model family: {family}")
        self.cfg, self.family = cfg, family
        self.device = resolve_device(device)
        self.image_size = int(cfg.get("data.image_size", 224))
        self.canvas = int(cfg.get("data.canvas", 256))
        self.batch_size = int(cfg.get("training.batch_size", 32))
        self.tokenizer = load_tokenizer(cfg.get("model.text_encoder.model_name"),
                                        vocab_size=cfg.get("model.text_encoder.vocab_size", 30522))
        # the tabular width from the metadata CSV, as the JAX Trainer's predict-only construction takes it
        # for every family (an MIBF or ConNexT artifact then takes a tabular input that its model ignores)
        self.tabular_dim = tabular_dim(cfg)
        self.model = build_model(cfg, family, self.tokenizer, device=self.device,
                                 tabular_dim=self.tabular_dim).eval()
        load_pretrained(self.model, cfg, family)  # the config's weights; --model_path loads after them
        # the test split's LLM hidden vectors go to the model where its Mamba fusion reads them
        self.hidden = bool(getattr(getattr(self.model, "cfg", None), "use_mamba_fusion", False)
                           and DatasetOptions.from_config(cfg, family, "test").llm_hidden_json)
        self._output_dir = output_dir
        self._servers: dict = {}

    @property
    def output_dir(self) -> str:
        """``{output.log_dir}/{output.run_name}_{timestamp}``, the JAX Trainer's run
        directory, made when first asked for."""
        if self._output_dir is None:
            stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
            self._output_dir = os.path.join(self.cfg.get("output.log_dir", "./runs"),
                                            f"{self.cfg.get('output.run_name', 'run')}_{stamp}")
        os.makedirs(self._output_dir, exist_ok=True)
        return self._output_dir

    def load_weights(self, path: str) -> None:
        load_weights(self.model, path, self.family)

    def make_test_loader(self, image_dir=None, json_path=None, csv_path=None) -> DataLoader:
        """The test split, the paths given overriding ``data.test_*``."""
        cfg = self.cfg
        d = cfg.get("data")
        image_dir = image_dir or d.get("test_image_dir")
        json_path = json_path or d.get("test_json_path")
        csv_path = csv_path if csv_path is not None else d.get("test_label_csv")
        opts = DatasetOptions.from_config(cfg, self.family, "test", canvas=self.canvas)
        ds = MultimodalDataset(image_dir, json_path, csv_path, self.tokenizer, opts)
        return DataLoader(ds, batch_size=self.batch_size)

    def server(self, tta: tuple = (), ablation_mode: Optional[str] = None) -> ServingModel:
        """The eval step for these options: a ServingModel at the loader's batch size."""
        key = (tuple(tta), ablation_mode)
        if key not in self._servers:
            self._servers[key] = ServingModel(self.model, self.batch_size, self.device, image_size=self.image_size,
                                              tta=tta, ablation_mode=ablation_mode, hidden=self.hidden)
        return self._servers[key]


def build_predictor(config_path: str, family: str = "baseline", overrides=None,
                    device: str | torch.device = "cuda", output_dir: Optional[str] = None) -> Predictor:
    """The Predictor of a config file; the device is resolved first, so a missing card
    raises before anything is read or built."""
    device = resolve_device(device)
    return Predictor(load_config(config_path, overrides=overrides), family=family, device=device,
                     output_dir=output_dir)


def build_trainer(config_path: str, family: str = "baseline", overrides=None, setup_data: bool = True,
                  output_dir: Optional[str] = None, device: str | torch.device = "cuda"):
    """The Trainer of a config file; the device is resolved first, so a missing card
    raises before anything is read or built."""
    device = resolve_device(device)
    return Trainer(load_config(config_path, overrides=overrides), family=family, output_dir=output_dir,
                   device=device, setup_data=setup_data)


def tta_transforms(tta_cfg) -> tuple:
    """``inference.tta`` -> the transforms to run: () when not enabled, ("hflip",)
    when enabled with none named (the JAX eval step's default)."""
    if not (tta_cfg and tta_cfg.get("enabled")):
        return ()
    return tuple(tta_cfg.get("transforms", ["hflip"]) or []) or ("hflip",)


def run_prediction(predictor: Predictor, loader, *, tta_cfg=None, ablation_mode=None):
    """(image_ids, predictions, float32 logits) over a loader, the next batch
    staged while the current one computes."""
    server = predictor.server(tta_transforms(tta_cfg), ablation_mode)
    pending = []

    def batches():
        for batch in loader:
            pending.append((batch["image_id"], int(batch["n_valid"])))
            yield batch

    ids, preds, all_logits = [], [], []
    for logits in server.predict_stream(batches(), depth=1):
        batch_ids, n = pending.pop(0)
        logits = np.asarray(logits[:n], np.float32)
        ids.extend(batch_ids[:n])
        preds.extend(logits.argmax(-1).tolist())
        all_logits.append(logits)
    return ids, preds, np.concatenate(all_logits, axis=0)
