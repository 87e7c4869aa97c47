"""JAX parameter trees -> PyTorch state_dicts (weights carried across).

The exact inverse of ``mdhs_tpu.core.convert``'s torch -> flax converters
(``convert_mibf_full``, ``convert_baseline_full``, ``convert_connext_full``,
``convert_bert``, ``convert_resnet_classifier``, ``convert_convnext_hf``,
``convert_mamba_vision``, ``convert_torch_mha``, ``_conv1x1``,
``_convert_kan_bank``):
the input is the JAX package's ``params`` / ``batch_stats`` (/ ``kan_state``)
trees as nested dicts of numpy arrays, the output a ``{name: Tensor}`` dict
that ``load_state_dict`` takes. Layouts:

- flax Dense kernel (in, out)  -> nn.Linear weight (out, in)
- flax Conv kernel HWIO        -> nn.Conv2d weight OIHW (a depthwise (7, 7, 1, C) -> (C, 1, 7, 7))
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var
- LayerNorm scale -> weight; Embed embedding -> weight
- MultiHeadAttention q/k/v_proj -> in_proj_weight (3E, E) where all three are
  E -> E, else q_proj_weight, k_proj_weight, v_proj_weight (E, width); in_proj_bias
- Mamba's depthwise conv HIO (d_conv, 1, d_inner) -> nn.Conv1d weight (d_inner, 1, d_conv), and
  MambaVision's ``conv1d_x`` / ``conv1d_z`` (k, 1, half) -> (half, 1, k)
- a vmapped KAN bank (leaves with a leading expert axis) -> experts.{e}.layers.{i}.*
- flax LSTM / GRU cells (``ii``..``io`` / ``ir``..``in`` input kernels,
  ``hi``..``ho`` / ``hr``..``hn`` recurrent ones) -> ``nn.LSTM`` / ``nn.GRU``
  names, the gates stacked in their order (i, f, g, o; r, z, n)

Every value is copied, so the tensors never alias the caller's arrays.

The second half reads reference torch state dicts as the JAX converters read
them, name for name, and returns the port's names: ``resnet_from_torchvision``
(``convert_resnet`` / ``convert_resnet_classifier``), ``bert_from_hf``
(``convert_bert``), ``convnext_from_reference`` (``convert_convnext_any``: the
HF ConvNextModel names, or torchvision's ``features.*`` renamed to them by
``convert_convnext_torchvision``'s table) and ``connext_from_reference``
(``convert_connext_full``: the Lightning wrappers peeled, the head, the
Mamba-fusion refusal). A name the JAX converter reads and the file lacks
raises KeyError, as there; the values are the file's own tensors.
"""

from __future__ import annotations

import logging
from typing import Mapping

import numpy as np
import torch

log = logging.getLogger(__name__)

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
    sequence encoder as ``sequence_state_dict_from_jax`` names it. A MambaVision
    tower (a trunk with a ``patch_embed``) is NVIDIA-named under
    ``image_encoder.model.`` by ``mamba_vision_state_dict_from_jax``, the names
    ``convert_mamba_vision`` reads; ``convert_baseline_full`` reads a ResNet
    trunk only."""
    img = params["image_encoder"]
    if "patch_embed" in img["trunk"]:
        out = mamba_vision_state_dict_from_jax(img["trunk"], batch_stats["image_encoder"]["trunk"],
                                               "image_encoder.model.")
    else:
        out = resnet_state_dict_from_jax({"trunk": img["trunk"]}, batch_stats["image_encoder"],
                                         "image_encoder.model.")
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


def mamba_vision_state_dict_from_jax(params: Tree, batch_stats: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``mdhs_tpu.models.mamba_vision.MambaVision`` (params, batch_stats) -> NVIDIA's
    names (``models/mamba_vision.py``); the exact inverse of ``convert_mamba_vision``."""
    out: dict[str, torch.Tensor] = {}
    pe, pe_s = params["patch_embed"], batch_stats["patch_embed"]
    for conv, bn, i in (("conv1", "bn1", 0), ("conv2", "bn2", 3)):
        _conv(pe[conv], f"{prefix}patch_embed.conv_down.{i}", out)
        _bn(pe[bn], pe_s[bn], f"{prefix}patch_embed.conv_down.{i + 1}", out)
    for name, p in params.items():
        if name.startswith("s") and "_conv" in name:
            stage, block = name[1:].split("_conv")
            base = f"{prefix}levels.{stage}.blocks.{block}."
            st = batch_stats[name]
            _conv(p["conv1"], base + "conv1", out)
            _bn(p["bn1"], st["bn1"], base + "norm1", out)
            _conv(p["conv2"], base + "conv2", out)
            _bn(p["bn2"], st["bn2"], base + "norm2", out)
            if "gamma" in p:
                out[base + "gamma"] = _t(p["gamma"])
        elif name.startswith("s") and "_block" in name:
            stage, block = name[1:].split("_block")
            base = f"{prefix}levels.{stage}.blocks.{block}."
            _ln(p["norm1"], base + "norm1", out)
            _ln(p["norm2"], base + "norm2", out)
            _lin(p["mlp_up"], base + "mlp.fc1", out)
            _lin(p["mlp_down"], base + "mlp.fc2", out)
            for g in ("gamma_1", "gamma_2"):
                if g in p:
                    out[base + g] = _t(p[g])
            if "attn" in p:
                _lin(p["attn"]["qkv"], base + "mixer.qkv", out)
                _lin(p["attn"]["proj"], base + "mixer.proj", out)
                continue
            m = p["mixer"]
            for n in ("in_proj", "x_proj", "out_proj"):
                out[f"{base}mixer.{n}.weight"] = _t(np.transpose(np.asarray(m[n]["kernel"]), (1, 0)))
            out[base + "mixer.dt_proj.weight"] = _t(np.transpose(np.asarray(m["dt_proj_kernel"]), (1, 0)))
            out[base + "mixer.dt_proj.bias"] = _t(m["dt_proj_bias"])
            out[base + "mixer.A_log"] = _t(m["A_log"])
            out[base + "mixer.D"] = _t(m["D"])
            for n in ("conv1d_x", "conv1d_z"):
                out[f"{base}mixer.{n}.weight"] = _t(np.transpose(np.asarray(m[n]), (2, 1, 0)))
        elif name.startswith("ds"):
            _conv(p, f"{prefix}levels.{int(name[2:]) - 1}.downsample.reduction.0", out)
    if "norm" in params:
        _bn(params["norm"], batch_stats["norm"], f"{prefix}norm", out)
    if "head" in params:
        _lin(params["head"], f"{prefix}head", out)
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


def kan_state_dict_from_jax(params: Tree, kan_state: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A ``KAN`` stack's params (``layer_{i}``) and kan_state (its grids) ->
    ``modules/kan.py``'s ``layers.{i}.*``."""
    out: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        base = f"{prefix}layers.{name[len('layer_'):]}."
        for leaf, a in p.items():
            out[base + leaf] = _t(a)
        out[base + "grid"] = _t(kan_state[name]["grid"])
    return out


def multimodal_mamba_state_dict_from_jax(params: Tree, kan_state: Tree | None,
                                         prefix: str = "") -> dict[str, torch.Tensor]:
    """``mdhs_tpu.modules.multimodal_mamba.MultimodalMamba`` (params, kan_state) ->
    ``modules/multimodal_mamba.py``'s names, which follow the JAX tree (no torch
    converter exists: ``convert_connext_full`` refuses the fusion)."""
    out: dict[str, torch.Tensor] = {}
    for name in ("proj_text", "proj_img", "proj_first", "proj_last"):
        _lin(params[name], prefix + name, out)
    if "attn" in params:
        attn, grids = params["attn"], kan_state["attn"]
        for name in ("q_proj", "k_proj", "v_proj"):
            out.update(kan_state_dict_from_jax(attn[name], grids[name], f"{prefix}attn.{name}."))
        _lin(attn["out_proj"], prefix + "attn.out_proj", out)
        _ln(params["norm1"], prefix + "norm1", out)
        _ln(params["norm2"], prefix + "norm2", out)
    out.update(mamba_state_dict_from_jax(params["mamba"], prefix + "mamba."))
    return out


def connext_state_dict_from_jax(params: Tree, kan_state: Tree | None = None) -> dict[str, torch.Tensor]:
    """``mdhs_tpu.models.connext.ConNexTClassifier`` (params, kan_state) -> state_dict
    of ``mdhs_tpu_torch.models.connext.ConNexTClassifier``; the inverse of
    ``convert_connext_full`` for either head (``moe`` when the tree has one,
    else ``fc``). A Mamba-fusion model's tree holds ``mamba_fusion`` and
    ``mamba_fc`` and neither ``reduce_conv``, the cross-attentions nor a head
    (flax made only what its forward called): those become
    ``multimodal_mamba_state_dict_from_jax``'s names under ``mamba_fusion.``,
    and ``mamba_fc``."""
    out = bert_state_dict_from_jax(params["text_encoder"], "text_encoder.bert.")
    out.update(convnext_state_dict_from_jax(params["image_encoder"], "image_encoder."))
    if "mamba_fusion" in params:
        out.update(multimodal_mamba_state_dict_from_jax(params["mamba_fusion"], (kan_state or {}).get("mamba_fusion"),
                                                        "mamba_fusion."))
        _lin(params["mamba_fc"], "mamba_fc", out)
        return out
    _conv(params["reduce_conv"], "conv", out)
    for name in ("textbased_cross_attention", "imagbased_cross_attention"):
        for conv in ("query_conv", "key_conv", "value_conv"):
            _conv(params[name][conv], f"{name}.{conv}", out)
    if "moe" in params:
        out.update(moe_state_dict_from_jax(params["moe"], kan_state["moe"], "moe."))
    else:
        _lin(params["fc"], "fc", out)
    return out


# ---------------------------------------------------------------------------
# Reference torch state dicts -> the port's names
# ---------------------------------------------------------------------------
# Each function reads what its ``mdhs_tpu.core.convert`` converter reads from a
# reference state dict (``module.`` already stripped by ``core/checkpoint.py``),
# and only that, raising KeyError on the same missing names; the output carries
# the port's names (the reference's, but for the torchvision ConvNeXt's, which
# become the HF names the port's tower has).

_BN = ("weight", "bias", "running_mean", "running_var")
_PAIR = ("weight", "bias")
_BERT_LAYER = tuple(f"{m}.{p}" for m in ("attention.self.query", "attention.self.key", "attention.self.value",
                                         "attention.output.dense", "attention.output.LayerNorm",
                                         "intermediate.dense", "output.dense", "output.LayerNorm") for p in _PAIR)
_CROSS = tuple(f"{a}_cross_attention.{q}_conv.{p}" for a in ("textbased", "imagbased")
               for q in ("query", "key", "value") for p in _PAIR)


def _strip_prefix(sd: Mapping, prefix: str) -> dict:
    """``prefix`` stripped from the names that start with it (the others kept)."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}


def _sub(sd: Mapping, prefix: str) -> dict:
    """The names under ``prefix``, stripped of it."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def resnet_from_torchvision(sd: Mapping, backbone: str = "resnet18", classifier: bool = False) -> dict:
    """A torchvision ResNet's trunk as ``convert_resnet`` reads it (a block's
    ``downsample`` where the file has one), with ``fc`` where ``classifier``
    and the file has one (``convert_resnet_classifier``)."""
    from ..models.resnet import STAGE_SIZES

    names = ["conv1.weight", *(f"bn1.{s}" for s in _BN)]
    n_convs = 3 if backbone == "resnet50" else 2
    for stage, n_blocks in enumerate(STAGE_SIZES[backbone], 1):
        for b in range(n_blocks):
            base = f"layer{stage}.{b}."
            for c in range(1, n_convs + 1):
                names += [f"{base}conv{c}.weight", *(f"{base}bn{c}.{s}" for s in _BN)]
            if f"{base}downsample.0.weight" in sd:
                names += [f"{base}downsample.0.weight", *(f"{base}downsample.1.{s}" for s in _BN)]
    if classifier and "fc.weight" in sd:
        names += ["fc.weight", "fc.bias"]
    return {n: sd[n] for n in names}


def bert_from_hf(sd: Mapping, num_layers: int = 12, prefix: str = "bert.") -> dict:
    """An HF BertModel as ``convert_bert`` reads it, rooted at ``prefix`` or
    else at ``embeddings.``; the pooler, which the port's towers lack, left out."""
    if not any(k.startswith(prefix) for k in sd):
        if not any(k.startswith("embeddings.") for k in sd):
            raise KeyError(f"bert_from_hf: no '{prefix}*' or 'embeddings.*' keys in the state dict "
                           f"(roots: {sorted({k.split('.')[0] for k in sd})[:8]})")
        prefix = ""
    names = [f"embeddings.{e}_embeddings.weight" for e in ("word", "position", "token_type")]
    names += [f"embeddings.LayerNorm.{p}" for p in _PAIR]
    names += [f"encoder.layer.{i}.{n}" for i in range(num_layers) for n in _BERT_LAYER]
    return {n: sd[prefix + n] for n in names}


def _convnext_hf_names(depths) -> list[tuple[str, str]]:
    """(HF ConvNextModel name, torchvision ``features`` name) of every tensor of a
    ConvNeXt tower (``convert_convnext_hf`` / ``convert_convnext_torchvision``)."""
    pairs = [(f"embeddings.patch_embeddings.{p}", f"0.0.{p}") for p in _PAIR]
    pairs += [(f"embeddings.layernorm.{p}", f"0.1.{p}") for p in _PAIR]
    for stage, depth in enumerate(depths):
        hf, tv = f"encoder.stages.{stage}.", 1 + 2 * stage
        if stage > 0:
            pairs += [(f"{hf}downsampling_layer.{i}.{p}", f"{2 * stage}.{i}.{p}") for i in (0, 1) for p in _PAIR]
        for b in range(depth):
            for hf_m, tv_m in (("dwconv", 0), ("layernorm", 2), ("pwconv1", 3), ("pwconv2", 5)):
                pairs += [(f"{hf}layers.{b}.{hf_m}.{p}", f"{tv}.{b}.block.{tv_m}.{p}") for p in _PAIR]
            pairs.append((f"{hf}layers.{b}.layer_scale_parameter", f"{tv}.{b}.layer_scale"))
    return pairs


def convnext_from_reference(sd: Mapping, variant: str = "base") -> dict:
    """A ConvNeXt tower under HF ConvNextModel names (a ``convnext.`` root
    stripped; its final ``layernorm`` and any classifier not read) or
    torchvision's ``features.*`` names, told apart as ``convert_convnext_any``
    tells them, under the HF names of ``models/convnext.py``; a layer scale
    flattened to (C,), as both JAX converters flatten it."""
    from ..models.convnext import CONVNEXT_SPECS

    pairs = _convnext_hf_names(CONVNEXT_SPECS[variant][0])
    if any("patch_embeddings" in k or "downsampling_layer" in k for k in sd):
        if any(k.startswith("convnext.") for k in sd):
            sd = _strip_prefix(sd, "convnext.")
        src = {hf: hf for hf, _ in pairs}
    else:
        if any(k.startswith("features.") for k in sd):
            sd = _strip_prefix(sd, "features.")
        src = dict(pairs)
    out = {hf: sd[src[hf]] for hf, _ in pairs}
    for k in out:
        if k.endswith("layer_scale_parameter"):
            out[k] = out[k].reshape(-1)
    return out


def _kan_bank_from_reference(sd: Mapping, prefix: str, num_experts=None) -> dict:
    """A ModuleList of KAN experts as ``_convert_kan_bank`` reads it: the experts
    counted in the file (a count that differs from ``num_experts`` raises
    ValueError), each layer's ``base_weight`` and ``spline_weight``, and its
    ``spline_scaler`` and ``grid`` where expert 0 has them."""
    n_ckpt = 0
    while f"{prefix}{n_ckpt}.layers.0.base_weight" in sd:
        n_ckpt += 1
    if n_ckpt == 0:
        raise KeyError(f"{prefix}0.layers.0.base_weight")
    if num_experts is not None and num_experts != n_ckpt:
        raise ValueError(f"checkpoint has {n_ckpt} experts under '{prefix}' but the model "
                         f"is configured with {num_experts} (model.moe.num_experts)")
    n_layers = 0
    while f"{prefix}0.layers.{n_layers}.base_weight" in sd:
        n_layers += 1
    names = []
    for i in range(n_layers):
        leaves = ["base_weight", "spline_weight"] + [n for n in ("spline_scaler", "grid")
                                                     if f"{prefix}0.layers.{i}.{n}" in sd]
        names += [f"{prefix}{e}.layers.{i}.{n}" for e in range(n_ckpt) for n in leaves]
    return {n: sd[n] for n in names}


def connext_from_reference(sd: Mapping, head: str = "linear", convnext_variant: str = "base",
                           num_bert_layers: int = 12, moe_num_experts=None, use_mamba_fusion: bool = False) -> dict:
    """A reference ConNexT state dict as ``convert_connext_full`` reads it: a
    Lightning ``Model4AAAI_MoE`` (``net.net.*``), a bare
    ``BaseLineConvNeXt_KAN_mamba`` (``net.*``) or a bare
    ``OurClassfierConvnextV2``; BERT under ``text_encoder.bert.``, the image
    tower in either naming (``convnext_from_reference``), the 1x1 reduction
    ``conv``, both cross-attentions and the ``fc`` or ``moe`` head. A model with
    the Mamba fusion is refused: no reference checkpoint has that head."""
    if use_mamba_fusion:
        raise ValueError("a reference ConNexT checkpoint cannot be imported into a mamba-fusion model "
                         "(model.mamba_fusion.enabled): no reference checkpoint for that head exists; "
                         "disable mamba fusion or train from scratch")
    for wrapper in ("net.net.", "net."):  # Model4AAAI_MoE.net.net / wrapper.net
        if any(k.startswith(wrapper + "text_encoder.") for k in sd):
            sd = _sub(sd, wrapper)
            break
    out = {"text_encoder.bert." + k: v for k, v in bert_from_hf(sd, num_bert_layers, "text_encoder.bert.").items()}
    out.update({"image_encoder." + k: v for k, v in
                convnext_from_reference(_sub(sd, "image_encoder."), convnext_variant).items()})
    out.update({n: sd[n] for n in ("conv.weight", "conv.bias", *_CROSS)})
    roots = sorted({k.split(".")[0] for k in sd})
    if head == "moe":
        if "moe.w_gate" not in sd:
            raise KeyError(f"head='moe' but no 'moe.w_gate' in the checkpoint (peeled keys start with: {roots})")
        out.update({n: sd[n] for n in ("moe.w_gate", "moe.w_noise")})
        out.update(_kan_bank_from_reference(sd, "moe.experts.", moe_num_experts))
    else:
        if "fc.weight" not in sd:
            raise KeyError(f"head='linear' but no 'fc.weight' in the checkpoint (peeled keys start with: {roots})")
        if "moe.w_gate" in sd:
            log.warning("checkpoint contains a 'moe.*' subtree but head='linear': importing the fc head and "
                        "discarding the MoE expert bank; set model.moe.enabled=true if the checkpoint was "
                        "trained through the MoE head")
        out.update({n: sd[n] for n in ("fc.weight", "fc.bias")})
    return out
