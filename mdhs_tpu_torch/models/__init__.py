"""ResNet, BERT, MIBF-Net, the baseline family and ConNexT as ``nn.Module``s
with torchvision / HF / reference names, and ``build_model``, which resolves a
config into one of them.

``build_model`` is ``mdhs_tpu/train/trainer.py::build_model`` (:101-146)
with ``bert_config_from`` (:74-97) and ``BaselineConfig.from_config``: the
same keys, defaults and family switch; the eval CLIs and the trainer both
build through it. What the port does not have raises
``NotImplementedError`` naming its ROADMAP item, from the model's own config
check. ``training.remat`` is checked as JAX checks it and not carried: it
changes only what a backward keeps, not what a step computes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.dtypes import DTypePolicy
from .baseline import BaselineConfig, MultimodalBaselineModel
from .bert import BertConfig
from .connext import ConNexTClassifier, ConNexTConfig
from .mibf import MIBFNet

FAMILIES = ("baseline", "mibf", "connext")
REMAT_MODES = ("none", "selective", "full")  # mdhs_tpu/core/remat.py::VALID_MODES


def bert_config_from(cfg, vocab_size: int) -> BertConfig:
    """``model.text_encoder.preset`` (base | tiny), ``model.fast_math``,
    ``model.text_encoder.attention_impl`` and ``.quantize``; the vocabulary
    at least the preset's."""
    fast = bool(cfg.get("model.fast_math", False))
    impl = cfg.get("model.text_encoder.attention_impl", "auto")
    quant = str(cfg.get("model.text_encoder.quantize", "none"))
    if cfg.get("model.text_encoder.preset", "base") == "tiny":
        base = BertConfig.tiny()
        return dataclasses.replace(base, vocab_size=max(vocab_size, base.vocab_size), fast_math=fast,
                                   attention_impl=impl, quantize=quant)
    return BertConfig(vocab_size=max(vocab_size, 30522), fast_math=fast, attention_impl=impl, quantize=quant)


def baseline_config_from(cfg, bert: BertConfig) -> BaselineConfig:
    """``mdhs_tpu.models.baseline.BaselineConfig.from_config`` (the tabular width from the
    config; ``build_model`` takes the dataset's)."""
    m = cfg.get("model")
    seq, gate, gl, tab = (m.get(k, {}) for k in ("sequence_encoder", "gate", "global_local", "tabular"))
    return BaselineConfig(
        num_classes=m.get("num_classes", 7),
        image_feature_dim=m.get("image_encoder.feature_dim", 512),
        text_feature_dim=m.get("text_encoder.feature_dim", 768),
        hidden_dim=m.get("mlp_head.hidden_dim", 256),
        dropout=m.get("mlp_head.dropout", 0.2),
        image_backbone=m.get("image_encoder.backbone", "resnet18"),
        classifier_type=m.get("classifier_type", "mlp"),
        fusion_type=m.get("fusion_type", "basic"),
        text_pool=m.get("text_pool", "cls"),
        kan_num_groups=m.get("kan.num_groups", 8),
        kan_act_mode=m.get("kan.act_mode", "gelu"),
        moe_num_experts=m.get("moe.num_experts", 4),
        moe_k=m.get("moe.k", 2),
        tabular_enabled=bool(tab.get("enabled", False)),
        tabular_input_dim=tab.get("input_dim", 0),
        tabular_hidden_dim=tab.get("hidden_dim", 128),
        tabular_dropout=tab.get("dropout", 0.1),
        gate_enabled=bool(gate.get("enabled", False)),
        gate_hidden_dim=gate.get("hidden_dim", 128),
        gate_use_entropy=bool(gate.get("use_entropy", True)),
        gate_local_mode=gate.get("local_mode", "image_only"),
        gate_context_mode=gate.get("context_mode", "full"),
        sequence_enabled=bool(seq.get("enabled", False)),
        sequence_type=seq.get("type", "lstm"),
        sequence_hidden_dim=seq.get("hidden_dim", m.get("mlp_head.hidden_dim", 256)),
        sequence_num_layers=seq.get("num_layers", 1),
        sequence_bidirectional=bool(seq.get("bidirectional", True)),
        sequence_dropout=seq.get("dropout", 0.1),
        sequence_num_heads=seq.get("num_heads", 4),
        global_local_enabled=bool(gl.get("enabled", False)),
        global_local_crop_ratio=gl.get("crop_ratio", 0.6),
        global_local_combine=gl.get("combine", "avg"),
        bert=bert,
    )


def connext_config_from(cfg, bert: BertConfig) -> ConNexTConfig:
    moe = cfg.get("model.moe", {})
    return ConNexTConfig(
        num_labels=cfg.get("model.num_classes", 7),
        convnext_variant=cfg.get("model.image_encoder.variant", "base"),
        head="moe" if moe.get("enabled", False) else "linear",
        moe_num_experts=moe.get("num_experts", 4),
        moe_k=moe.get("k", 2),
        moe_expert_layers=tuple(moe["expert_layers"]) if moe.get("expert_layers") else None,
        use_mamba_fusion=bool(cfg.get("model.mamba_fusion.enabled", False)),
        llm_hidden_dim=int(cfg.get("data.llm_hidden_dim", cfg.get("model.mamba_fusion.llm_hidden_dim", 3584))),
        bert=bert,
    )


def model_config(cfg, family: str, vocab_size: int):
    """What ``build_model`` builds: ``BaselineConfig``, ``ConNexTConfig``, or
    MIBFNet's keyword arguments {"num_labels", "bert"}."""
    remat = str(cfg.get("training.remat", "none"))
    if remat not in REMAT_MODES:
        raise ValueError(f"training.remat={remat!r}: expected one of {REMAT_MODES}")
    bert = bert_config_from(cfg, vocab_size)
    if family == "baseline":
        return baseline_config_from(cfg, bert)
    if family == "mibf":
        return {"num_labels": cfg.get("model.num_classes", 6), "bert": bert}
    if family == "connext":
        return connext_config_from(cfg, bert)
    raise ValueError(f"unknown model family: {family}")


def build_model(cfg, family: str, tokenizer, device=None, dtype: torch.dtype | None = None, tabular_dim: int = 0):
    """The family's model for ``cfg`` in the config's precision
    (``training.precision``, bf16 by default), with PyTorch's default init.
    ``tabular_dim``, the tabular branch's input width (the dataset's, as JAX's
    ``build_model`` takes it), replaces ``model.tabular.input_dim`` where it is
    not 0."""
    if dtype is None:
        dtype = DTypePolicy.from_config(cfg).compute_dtype
    spec = model_config(cfg, family, tokenizer.vocab_size)
    if family == "baseline" and tabular_dim:
        spec = dataclasses.replace(spec, tabular_input_dim=tabular_dim)
    f = dict(device=device, dtype=dtype)
    if family == "baseline":
        return MultimodalBaselineModel(spec, **f)
    if family == "mibf":
        return MIBFNet(**spec, **f)
    return ConNexTClassifier(spec, **f)
