"""JAX parameter trees -> PyTorch state_dicts (weights carried across).

The exact inverse of ``mdhs_tpu.core.convert``'s torch -> flax converters
(``convert_mibf_full``, ``convert_baseline_full``, ``convert_connext_full``,
``convert_bert``, ``convert_resnet_classifier``, ``convert_convnext_hf``,
``convert_torch_mha``, ``_conv1x1``, ``_convert_kan_bank``):
the input is the JAX package's ``params`` / ``batch_stats`` (/ ``kan_state``)
trees as nested dicts of numpy arrays, the output a ``{name: Tensor}`` dict
that ``load_state_dict`` takes. Layouts:

- flax Dense kernel (in, out)  -> nn.Linear weight (out, in)
- flax Conv kernel HWIO        -> nn.Conv2d weight OIHW (a depthwise (7, 7, 1, C) -> (C, 1, 7, 7))
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var
- LayerNorm scale -> weight; Embed embedding -> weight
- MultiHeadAttention q/k/v_proj -> in_proj_weight (3E, E) where all three are
  E -> E, else q_proj_weight, k_proj_weight, v_proj_weight (E, width); in_proj_bias
- Mamba's depthwise conv HIO (d_conv, 1, d_inner) -> nn.Conv1d weight (d_inner, 1, d_conv)
- a vmapped KAN bank (leaves with a leading expert axis) -> experts.{e}.layers.{i}.*
- flax LSTM / GRU cells (``ii``..``io`` / ``ir``..``in`` input kernels,
  ``hi``..``ho`` / ``hr``..``hn`` recurrent ones) -> ``nn.LSTM`` / ``nn.GRU``
  names, the gates stacked in their order (i, f, g, o; r, z, n)

Every value is copied, so the tensors never alias the caller's arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

Tree = Mapping[str, object]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _lin(d: Tree, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(np.transpose(np.asarray(d["kernel"]), (1, 0)))
    out[f"{name}.bias"] = _t(d["bias"])


def _ln(d: Tree, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(d["scale"])
    out[f"{name}.bias"] = _t(d["bias"])


def _conv(d: Tree, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(np.transpose(np.asarray(d["kernel"]), (3, 2, 0, 1)))  # HWIO -> OIHW
    if "bias" in d:
        out[f"{name}.bias"] = _t(d["bias"])


def _bn(p: Tree, s: Tree, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])
    out[f"{name}.running_mean"] = _t(s["mean"])
    out[f"{name}.running_var"] = _t(s["var"])


def bert_state_dict_from_jax(params: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``mdhs_tpu.models.bert.BertModel`` params -> HF-named BertModel state_dict."""
    out: dict[str, torch.Tensor] = {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"{prefix}embeddings.{name}.weight"] = _t(params[name]["embedding"])
    _ln(params["embeddings_layernorm"], f"{prefix}embeddings.LayerNorm", out)
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        p = params[f"layer_{i}"]
        base = f"{prefix}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            _lin(p["attention"][name], base + f"attention.self.{name}", out)
        _lin(p["attention_output"], base + "attention.output.dense", out)
        _ln(p["attention_layernorm"], base + "attention.output.LayerNorm", out)
        _lin(p["intermediate"], base + "intermediate.dense", out)
        _lin(p["output"], base + "output.dense", out)
        _ln(p["output_layernorm"], base + "output.LayerNorm", out)
    return out


def resnet_state_dict_from_jax(params: Tree, batch_stats: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``ResNetClassifier`` trees ({"trunk", "fc"}) -> torchvision-named state_dict."""
    p, s = params["trunk"], batch_stats["trunk"]
    out: dict[str, torch.Tensor] = {}
    _conv(p["stem_conv"], f"{prefix}conv1", out)
    _bn(p["stem_bn"], s["stem_bn"], f"{prefix}bn1", out)
    blocks = sorted(
        (k for k in p if k.startswith("layer")),
        key=lambda k: tuple(int(x) for x in k[len("layer"):].split("_block")),
    )
    for fname in blocks:
        stage, block = fname[len("layer"):].split("_block")
        base = f"{prefix}layer{stage}.{block}."
        bp, bs = p[fname], s[fname]
        for conv in sorted(k for k in bp if k.startswith("conv")):
            _conv(bp[conv], base + conv, out)
            bn = "bn" + conv[len("conv"):]
            _bn(bp[bn], bs[bn], base + bn, out)
        if "downsample_conv" in bp:
            _conv(bp["downsample_conv"], base + "downsample.0", out)
            _bn(bp["downsample_bn"], bs["downsample_bn"], base + "downsample.1", out)
    if "fc" in params:
        _lin(params["fc"], f"{prefix}fc", out)
    return out


def joint_kv_state_dict_from_jax(params: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    names = {"to_q_x": "toQ_x", "to_k_x": "toK_x", "to_v_x": "toV_x",
             "to_k_y": "toK_y", "to_v_y": "toV_y", "to_out": "to_out"}
    out: dict[str, torch.Tensor] = {}
    for flax_name, torch_name in names.items():
        _lin(params[flax_name], f"{prefix}{torch_name}", out)
    return out


def mibf_state_dict_from_jax(params: Tree, batch_stats: Tree) -> dict[str, torch.Tensor]:
    """``mdhs_tpu.models.mibf.MIBFNet`` (params, batch_stats) -> state_dict of
    ``mdhs_tpu_torch.models.mibf.MIBFNet``; the inverse of ``convert_mibf_full``."""
    out = bert_state_dict_from_jax(params["text_encoder"], "text_encoder.bert.")
    out.update(resnet_state_dict_from_jax(
        params["image_encoder"], batch_stats["image_encoder"], "image_encoder."))
    for name in ("textbased_cross_attention", "imagbased_cross_attention"):
        out.update(joint_kv_state_dict_from_jax(params[name], f"{name}."))
    _lin(params["fc"], "fc", out)
    _lin(params["fc_image_hidden"], "fc_image.1", out)
    _lin(params["fc_image_out"], "fc_image.3", out)
    _lin(params["fc_text_hidden"], "fc_text.1", out)
    _lin(params["fc_text_out"], "fc_text.3", out)
    return out


def mha_state_dict_from_jax(params: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``MultiHeadAttention`` params -> nn.MultiheadAttention names: q/k/v packed
    where each is E -> E, else one weight each (keys and values of another width)."""
    names = ("q_proj", "k_proj", "v_proj")
    w = [np.transpose(np.asarray(params[n]["kernel"]), (1, 0)) for n in names]
    out = {f"{prefix}in_proj_bias": _t(np.concatenate([np.asarray(params[n]["bias"]) for n in names]))}
    E = w[0].shape[0]
    if all(a.shape == (E, E) for a in w):
        out[f"{prefix}in_proj_weight"] = _t(np.concatenate(w, axis=0))
    else:
        out.update({f"{prefix}{n}_weight": _t(a) for n, a in zip(names, w)})
    _lin(params["out_proj"], f"{prefix}out_proj", out)
    return out


def mamba_state_dict_from_jax(params: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``MambaBlock`` params -> ``modules/mamba.py::MambaBlock`` (mamba_ssm names)."""
    out: dict[str, torch.Tensor] = {}
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        out[f"{prefix}{name}.weight"] = _t(np.transpose(np.asarray(params[name]["kernel"]), (1, 0)))
    out[f"{prefix}conv1d.weight"] = _t(np.transpose(np.asarray(params["conv1d_weight"]), (2, 1, 0)))
    out[f"{prefix}conv1d.bias"] = _t(params["conv1d_bias"])
    for name in ("dt_bias", "A_log", "D"):
        out[f"{prefix}{name}"] = _t(params[name])
    return out


def moe_state_dict_from_jax(params: Tree, kan_state: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``MoE`` params + kan_state (the experts' stacked leaves) -> per-expert
    ``experts.{e}.layers.{i}.*``, the layout ``_convert_kan_bank`` reads."""
    out = {f"{prefix}w_gate": _t(params["w_gate"]), f"{prefix}w_noise": _t(params["w_noise"])}
    experts, grids = params["experts"], kan_state["experts"]
    for i in range(sum(1 for k in experts if k.startswith("layer_"))):
        leaves = dict(experts[f"layer_{i}"], grid=grids[f"layer_{i}"]["grid"])
        for name, stacked in leaves.items():
            for e, a in enumerate(np.asarray(stacked)):
                out[f"{prefix}experts.{e}.layers.{i}.{name}"] = _t(a)
    return out


def head_state_dict_from_jax(head: Tree, kan_state: Tree | None, classifier_type: str,
                             prefix: str = "") -> dict[str, torch.Tensor]:
    """A baseline head's params (and, for ``moe``, its kan_state) -> the port's
    ``modules/heads.py`` names under ``prefix``: ``mlp`` and ``residual`` as
    ``_convert_head`` reads them; ``kan`` and ``attention_pooling`` after the JAX
    tree; ``moe`` in ``_convert_kan_bank``'s layout."""
    out: dict[str, torch.Tensor] = {}
    if classifier_type == "mlp":
        _lin(head["fc1"], f"{prefix}0", out)
        _lin(head["fc2"], f"{prefix}3", out)
    elif classifier_type == "residual":
        for jname, name in (("project", "project"), ("res_fc1", "res_block.linear1"),
                            ("res_fc2", "res_block.linear2"), ("classifier", "classifier")):
            _lin(head[jname], f"{prefix}{name}", out)
        _ln(head["res_norm"], f"{prefix}res_block.norm", out)
    elif classifier_type == "attention_pooling":
        out[f"{prefix}query"] = _t(head["query"])
        out.update(mha_state_dict_from_jax(head["attn"], f"{prefix}attn."))
        _lin(head["classifier"], f"{prefix}classifier", out)
    elif classifier_type == "kan":
        for name in ("kan1", "kan2"):
            out[f"{prefix}{name}.act_coeff"] = _t(head[name]["act_coeff"])
            out[f"{prefix}{name}.act_base"] = _t(head[name]["act_base"])
            _lin(head[name]["linear"], f"{prefix}{name}.linear", out)
        _ln(head["norm"], f"{prefix}norm", out)
    elif classifier_type == "moe":
        out.update(moe_state_dict_from_jax(head["moe"], kan_state["moe"], f"{prefix}moe."))
    else:
        raise ValueError(f"no converter for classifier_type={classifier_type!r}")
    return out


def sequence_state_dict_from_jax(params: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``mdhs_tpu.modules.sequence.SequenceEncoder`` params -> ``modules/sequence.py``'s
    names (the kind read from the tree): ``fwd_{k}`` / ``bwd_{k}`` cells to
    ``rnn.*_l{k}`` / ``rnn.*_l{k}_reverse``, ``layer_{k}`` to ``encoder.layers.{k}``
    (``self_attn`` as ``nn.MultiheadAttention``, ``ff1`` / ``ff2`` to ``linear1`` /
    ``linear2``), ``proj``. ``convert_baseline_full`` maps no sequence weights, so
    these names are the reference's ``nn.LSTM`` / ``nn.GRU`` /
    ``nn.TransformerEncoderLayer`` ones."""
    out: dict[str, torch.Tensor] = {}

    def stack(cell: Tree, names: str, key: str) -> torch.Tensor:
        return _t(np.concatenate([np.asarray(cell[n][key]).T if key == "kernel" else np.asarray(cell[n][key])
                                  for n in names], axis=0))

    for name, p in params.items():
        if name == "proj":
            _lin(p, f"{prefix}proj", out)
        elif name.startswith("layer_"):
            base = f"{prefix}encoder.layers.{name[len('layer_'):]}."
            out.update(mha_state_dict_from_jax(p["self_attn"], base + "self_attn."))
            _lin(p["ff1"], base + "linear1", out)
            _lin(p["ff2"], base + "linear2", out)
            _ln(p["norm1"], base + "norm1", out)
            _ln(p["norm2"], base + "norm2", out)
        else:
            direction, k = name.split("_")
            cell, sfx = p["cell"], "_reverse" if direction == "bwd" else ""
            rnn = f"{prefix}rnn."
            gates = "ifgo" if "ii" in cell else "rzn"
            out[f"{rnn}weight_ih_l{k}{sfx}"] = stack(cell, [f"i{g}" for g in gates], "kernel")
            out[f"{rnn}weight_hh_l{k}{sfx}"] = stack(cell, [f"h{g}" for g in gates], "kernel")
            if gates == "ifgo":
                out[f"{rnn}bias_hh_l{k}{sfx}"] = stack(cell, [f"h{g}" for g in gates], "bias")
            else:
                out[f"{rnn}bias_ih_l{k}{sfx}"] = stack(cell, [f"i{g}" for g in gates], "bias")
                out[f"{rnn}bias_hh_l{k}{sfx}"] = _t(cell["hn"]["bias"])
    return out


def fusion_state_dict_from_jax(fusion: Tree, fusion_type: str, prefix: str = "fusion.") -> dict[str, torch.Tensor]:
    """A baseline fusion's params -> ``modules/fusion.py``'s names under ``prefix``:
    the inverse of ``_convert_fusion`` for ``basic``, ``multiscale``, ``concat``,
    ``weighted_concat``, ``hadamard`` and ``bilinear``; ``hierarchical`` as
    ``multiscale`` plus ``scale_weights``, ``mamba`` and ``vmamba`` after the JAX
    tree, their Mamba blocks in mamba_ssm's names (``_convert_fusion`` maps none
    of the three)."""
    out: dict[str, torch.Tensor] = {}
    if fusion_type == "basic":
        p, name = fusion["block"], f"{prefix}transformer_block"
        for n in ("norm1", "norm2", "norm3"):
            _ln(p[n], f"{name}.{n}", out)
        for n in ("attn1", "attn2"):
            out.update(mha_state_dict_from_jax(p[n], f"{name}.{n}."))
        _lin(p["ff_up"], f"{name}.ff.0", out)
        _lin(p["ff_down"], f"{name}.ff.3", out)
    elif fusion_type in ("multiscale", "hierarchical"):
        for s in (2, 3, 4):
            p, name = fusion[f"cross_layer{s}"], f"{prefix}cross_l{s}"
            _lin(p["txt_proj"], f"{name}.txt_proj", out)
            out.update(mha_state_dict_from_jax(p["attn"], f"{name}.attn."))
            _ln(p["norm"], f"{name}.norm", out)
        if fusion_type == "hierarchical":
            out[f"{prefix}scale_weights"] = _t(fusion["scale_weights"])
    elif fusion_type in ("concat", "weighted_concat"):
        _lin(fusion["proj"], f"{prefix}proj", out)
        if fusion_type == "weighted_concat":
            out[f"{prefix}w_img"] = _t(fusion["w_img"])
            out[f"{prefix}w_txt"] = _t(fusion["w_txt"])
    elif fusion_type in ("hadamard", "bilinear"):
        for n in ("img_proj", "txt_proj") + (("out_proj",) if fusion_type == "bilinear" else ()):
            _lin(fusion[n], f"{prefix}{n}", out)
        _ln(fusion["norm"], f"{prefix}norm", out)
    elif fusion_type == "mamba":
        _lin(fusion["txt_proj"], f"{prefix}txt_proj", out)
        out.update(mamba_state_dict_from_jax(fusion["mamba"], f"{prefix}mamba."))
    elif fusion_type == "vmamba":
        for n in ("txt_proj", "in_proj", "out_proj"):
            _lin(fusion[n], f"{prefix}{n}", out)
        vm = fusion["vmamba"]
        _ln(vm["norm"], f"{prefix}vmamba.norm", out)
        for n in ("fwd", "bwd"):
            out.update(mamba_state_dict_from_jax(vm[n], f"{prefix}vmamba.{n}."))
    else:
        raise ValueError(f"no converter for fusion_type={fusion_type!r}")
    return out


def baseline_state_dict_from_jax(params: Tree, batch_stats: Tree, kan_state: Tree | None = None,
                                 fusion_type: str = "multiscale",
                                 classifier_type: str = "mlp") -> dict[str, torch.Tensor]:
    """``mdhs_tpu.models.baseline.MultimodalBaselineModel`` (params,
    batch_stats, kan_state) -> state_dict of
    ``mdhs_tpu_torch.models.baseline.MultimodalBaselineModel``: the inverse of
    ``convert_baseline_full`` for the fusions it maps (``basic``,
    ``multiscale``, ``concat``, ``weighted_concat``, ``hadamard``,
    ``bilinear``) with the ``mlp`` and ``residual`` heads; the others as
    ``fusion_state_dict_from_jax`` names them, and every head as
    ``head_state_dict_from_jax`` names it. The ``kan`` and
    ``attention_pooling`` heads have no torch converter in the JAX package;
    their names follow the JAX tree (``classifier.kan1.act_coeff``,
    ``classifier.kan1.linear.weight``, ``classifier.norm.weight``;
    ``classifier.query``, ``classifier.attn.*`` as ``nn.MultiheadAttention``,
    ``classifier.classifier.weight``). The branches: ``tabular_encoder.net.{0,3}``,
    ``tabular_fusion.0``, ``gate.fc.{0,2}``, ``sequence_proj`` and
    ``global_local_proj`` as ``convert_baseline_full`` reads them, and the
    sequence encoder as ``sequence_state_dict_from_jax`` names it."""
    img = params["image_encoder"]
    out = resnet_state_dict_from_jax({"trunk": img["trunk"]}, batch_stats["image_encoder"], "image_encoder.model.")
    for s in (2, 3, 4):
        if f"proj_layer{s}" in img:
            _lin(img[f"proj_layer{s}"], f"image_encoder.proj{s}", out)
    out.update(bert_state_dict_from_jax(params["text_encoder"]["bert"], "text_encoder.model."))
    out.update(fusion_state_dict_from_jax(params["fusion"], fusion_type))
    out.update(head_state_dict_from_jax(params["classifier"], (kan_state or {}).get("classifier"), classifier_type,
                                        "classifier."))
    if "tabular_encoder" in params:
        _lin(params["tabular_encoder"]["fc1"], "tabular_encoder.net.0", out)
        _lin(params["tabular_encoder"]["fc2"], "tabular_encoder.net.3", out)
        _lin(params["tabular_fc"], "tabular_fusion.0", out)
    if "gate" in params:
        _lin(params["gate"]["fc1"], "gate.fc.0", out)
        _lin(params["gate"]["fc2"], "gate.fc.2", out)
    for name in ("sequence_proj", "global_local_proj"):
        if name in params:
            _lin(params[name], name, out)
    if "sequence_encoder" in params:
        out.update(sequence_state_dict_from_jax(params["sequence_encoder"], "sequence_encoder."))
    return out


def convnext_state_dict_from_jax(params: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``mdhs_tpu.models.convnext.ConvNeXt`` params -> HF ``ConvNextModel`` names
    (``models/convnext.py``); the inverse of ``convert_convnext_hf``."""
    out: dict[str, torch.Tensor] = {}
    _conv(params["stem_conv"], f"{prefix}embeddings.patch_embeddings", out)
    _ln(params["stem_norm"], f"{prefix}embeddings.layernorm", out)
    for name, p in params.items():
        if name.startswith("ds") and name.endswith("_norm"):
            _ln(p, f"{prefix}encoder.stages.{name[2:-5]}.downsampling_layer.0", out)
        elif name.startswith("ds") and name.endswith("_conv"):
            _conv(p, f"{prefix}encoder.stages.{name[2:-5]}.downsampling_layer.1", out)
        elif name.startswith("stage"):
            stage, block = name[len("stage"):].split("_block")
            base = f"{prefix}encoder.stages.{stage}.layers.{block}."
            _conv(p["dwconv"], base + "dwconv", out)
            _ln(p["norm"], base + "layernorm", out)
            _lin(p["pwconv1"], base + "pwconv1", out)
            _lin(p["pwconv2"], base + "pwconv2", out)
            out[base + "layer_scale_parameter"] = _t(p["gamma"])
    return out


def connext_state_dict_from_jax(params: Tree, kan_state: Tree | None = None) -> dict[str, torch.Tensor]:
    """``mdhs_tpu.models.connext.ConNexTClassifier`` (params, kan_state) -> state_dict
    of ``mdhs_tpu_torch.models.connext.ConNexTClassifier``; the inverse of
    ``convert_connext_full`` for either head (``moe`` when the tree has one,
    else ``fc``)."""
    out = bert_state_dict_from_jax(params["text_encoder"], "text_encoder.bert.")
    out.update(convnext_state_dict_from_jax(params["image_encoder"], "image_encoder."))
    _conv(params["reduce_conv"], "conv", out)
    for name in ("textbased_cross_attention", "imagbased_cross_attention"):
        for conv in ("query_conv", "key_conv", "value_conv"):
            _conv(params[name][conv], f"{name}.{conv}", out)
    if "moe" in params:
        out.update(moe_state_dict_from_jax(params["moe"], kan_state["moe"], "moe."))
    else:
        _lin(params["fc"], "fc", out)
    return out
