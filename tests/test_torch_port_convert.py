"""Weight conversion of mdhs_tpu_torch against the JAX package's, on the CPU:
``cli/convert_weights.py`` and the reference ConNexT checkpoints.

``convert_weights``: each kind's reference file (a torchvision ResNet18 /
ResNet50 with its 1000-class ``fc``, a ResNet50 with the 768-out MIBF head, an
HF ``BertForSequenceClassification``-style ``bert.*`` file with its pooler and
head, an HF and a torchvision ConvNeXt, a Lightning ConNexT with either head)
goes through the JAX CLI and the port's. The JAX msgpack is merged into the
JAX model's trees (``mdhs_tpu.core.checkpoint.merge_tolerant``, as the JAX
Trainer's ``load_weights``) and carried across (``*_state_dict_from_jax``);
the port's file is loaded by ``core/checkpoint.py::load_weights`` into the
port model holding the same weights before: every tensor bit for bit, and
the tower's the file's own. Models: pico widths (a two-layer BERT 32 wide,
the registered ``port_pico`` ConvNeXt of tests/test_torch_port_connext.py),
full-width ResNets at no input.

The reference ConNexT repair: a pico ConNexT's state dict saved bare, under
the Lightning wrappers ``net.net.`` / ``net.`` and with its image tower under
torchvision's names loads through ``load_weights`` bit for bit as
``convert_connext_full`` of the same file carried across with
``connext_state_dict_from_jax``; a file that lacks a key and a Mamba-fusion
model raise ValueError.
"""

import functools

import numpy as np
import pytest
import torch

from mdhs_tpu.cli import convert_weights as jcw
from mdhs_tpu.core import checkpoint as jckpt
from mdhs_tpu.core.convert import convert_baseline_full, convert_connext_full, convert_mibf_full
from mdhs_tpu.models import convnext as jconvnext
from mdhs_tpu_torch.cli import convert_weights as tcw
from mdhs_tpu_torch.core import convert as tconvert
from mdhs_tpu_torch.core.checkpoint import load_weights
from mdhs_tpu_torch.core.config import Config
from mdhs_tpu_torch.core.pretrained import load_pretrained
from mdhs_tpu_torch.models import baseline as tbase
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models import connext as tconnext
from mdhs_tpu_torch.models import convnext as tconvnext
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.models.mibf import MIBFNet

torch.set_num_threads(2)
BERT = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
PICO = ((2, 2, 2, 2), (16, 24, 32, 40))


@pytest.fixture(scope="module", autouse=True)
def pico_zoo():
    with pytest.MonkeyPatch.context() as mp:
        for module in (jconvnext, tconvnext):
            mp.setitem(module.CONVNEXT_SPECS, "port_pico", PICO)
        yield


def _seeded(model, seed):
    """``model`` with seeded weights, its norms' affines and statistics drawn too."""
    init_parameters(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_var", "layer_scale_parameter")) or (t.ndim == 1 and "norm" in name.lower()):
                t.uniform_(0.5, 1.5, generator=g)
            elif name.endswith(("running_mean", ".bias")):
                t.uniform_(-0.2, 0.2, generator=g)
    return model.eval()


def _np(sd):
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


FAMILIES = {  # each family's port model, the JAX full converter of its state dict, the way back
    "baseline": (lambda: tbase.MultimodalBaselineModel(tbase.BaselineConfig(
        hidden_dim=32, text_feature_dim=32, num_heads=4, fusion_type="multiscale", bert=tbert.BertConfig(**BERT))),
        lambda sd: convert_baseline_full(sd, "multiscale", "mlp", "resnet18", 2) + ({},),
        lambda p, s, k: tconvert.baseline_state_dict_from_jax(p, s, k, "multiscale", "mlp")),
    "mibf": (lambda: MIBFNet(7, tbert.BertConfig(**BERT)),
             lambda sd: convert_mibf_full(sd, num_bert_layers=2) + ({},),
             lambda p, s, k: tconvert.mibf_state_dict_from_jax(p, s)),
    "connext": (lambda: tconnext.ConNexTClassifier(tconnext.ConNexTConfig(
        convnext_variant="port_pico", fusion_dim=32, head="moe", moe_expert_layers=(32, 16, 7),
        bert=tbert.BertConfig(**BERT))),
        lambda sd: convert_connext_full(sd, head="moe", convnext_variant="port_pico", num_bert_layers=2),
        lambda p, s, k: tconvert.connext_state_dict_from_jax(p, k)),
}


@functools.lru_cache(maxsize=None)
def _target(family):
    """(the seeded state dict a family's model starts from, the JAX trees of the same weights)."""
    sd = _seeded(FAMILIES[family][0](), 11).state_dict()
    return (sd, *FAMILIES[family][1](_np(sd)))


def _source_files():
    """{kind case: (reference state dict, JAX / port flags)}, each from a seeded port module."""
    r18 = _seeded(tbase.MultimodalBaselineModel(tbase.BaselineConfig(bert=tbert.BertConfig(**BERT))), 5)
    r18 = {k[len("image_encoder.model."):]: v for k, v in r18.state_dict().items()
           if k.startswith("image_encoder.model.")}
    r18.update({"fc.weight": torch.ones(1000, 512), "fc.bias": torch.zeros(1000)})
    r50 = _seeded(MIBFNet(7, tbert.BertConfig(**BERT)), 6).state_dict()
    r50 = {k[len("image_encoder."):]: v for k, v in r50.items() if k.startswith("image_encoder.")}
    bert = _seeded(tbert.BertModel(tbert.BertConfig(**BERT)), 7).state_dict()
    bert = {"bert." + k: v for k, v in bert.items()}
    bert.update({"bert.pooler.dense.weight": torch.ones(32, 32), "bert.pooler.dense.bias": torch.zeros(32),
                 "classifier.weight": torch.ones(2, 32)})
    hf = {k: v for k, v in _seeded(tconvnext.ConvNeXt("port_pico"), 8).state_dict().items()}
    tv = _torchvision(hf)
    hf = {"convnext." + k: v for k, v in hf.items()}
    hf.update({"convnext.layernorm.weight": torch.ones(40), "classifier.weight": torch.ones(3, 40)})
    connext = {"net.net." + k: v for k, v in _seeded(FAMILIES["connext"][0](), 9).state_dict().items()}
    return {
        "resnet-baseline": (r18, ["--kind", "resnet", "--dest", "image_encoder"], "baseline"),
        "resnet-mibf": (r50, ["--kind", "resnet", "--backbone", "resnet50", "--dest", "image_encoder"], "mibf"),
        "resnet_classifier-mibf": (r50, ["--kind", "resnet_classifier", "--backbone", "resnet50",
                                         "--dest", "image_encoder"], "mibf"),
        "bert-baseline": (bert, ["--kind", "bert", "--num_layers", "2", "--dest", "text_encoder"], "baseline"),
        "convnext_hf-connext": (hf, ["--kind", "convnext", "--variant", "port_pico", "--dest", "image_encoder"],
                                "connext"),
        "convnext_torchvision-connext": (tv, ["--kind", "convnext", "--variant", "port_pico",
                                              "--dest", "image_encoder"], "connext"),
        "connext_full-connext": (connext, ["--kind", "connext_full", "--variant", "port_pico", "--num_layers", "2",
                                           "--head", "moe"], "connext"),
    }


def _torchvision(hf: dict, prefix: str = "") -> dict:
    """An HF-named ConvNeXt tower under torchvision's ``features.*`` names (the layer scale (C, 1, 1)):
    ``convert_convnext_torchvision``'s table, written out here on its own."""
    out = {}
    for k, v in hf.items():
        parts = k.split(".")
        if k.startswith("embeddings."):
            tv = f"0.{0 if parts[1] == 'patch_embeddings' else 1}.{parts[-1]}"
        elif "downsampling_layer" in k:
            tv = f"{2 * int(parts[2])}.{parts[4]}.{parts[5]}"
        else:
            stage, block, module = int(parts[2]), parts[4], parts[5]
            if module == "layer_scale_parameter":
                tv, v = f"{1 + 2 * stage}.{block}.layer_scale", v.reshape(-1, 1, 1)
            else:
                index = {"dwconv": 0, "layernorm": 2, "pwconv1": 3, "pwconv2": 5}[module]
                tv = f"{1 + 2 * stage}.{block}.block.{index}.{parts[6]}"
        out[prefix + "features." + tv] = v
    return out


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    files = {}
    for case, (sd, flags, family) in _source_files().items():
        path = str(root / f"{case}.pth")
        torch.save(sd, path)
        files[case] = (path, flags, family)
    return files


@pytest.mark.parametrize("case", ["resnet-baseline", "resnet-mibf", "resnet_classifier-mibf", "bert-baseline",
                                  "convnext_hf-connext", "convnext_torchvision-connext", "connext_full-connext"])
def test_convert_weights_matches_the_jax_cli(sources, case, tmp_path):
    path, flags, family = sources[case]
    make, _, carry = FAMILIES[family]
    jcw.main(["--input", path, "--output", str(tmp_path / "w.msgpack"), *flags])
    state = tcw.main(["--input", path, "--output", str(tmp_path / "w.pt"), "--family", family, *flags])
    start, params, stats, kan = _target(family)
    model = make().eval()
    model.load_state_dict(start)
    loaded = jckpt.load_checkpoint(str(tmp_path / "w.msgpack"))
    merged = [jckpt.merge_tolerant(tree, loaded.get(key, {})) if tree else tree
              for tree, key in ((params, "params"), (stats, "batch_stats"), (kan, "kan_state"))]
    want = carry(*merged)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_weights(model, str(tmp_path / "w.pt"), family)
    got = model.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    written = state["state_dict"]
    assert written and all(torch.equal(got[k], v.to(got[k].dtype)) for k, v in written.items())
    assert any(not torch.equal(before[k], got[k]) for k in written)


@pytest.mark.parametrize("kind, family, dest", [("bert", "mibf", "text_encoder"), ("resnet", "baseline", ""),
                                                ("resnet_classifier", "baseline", "image_encoder"),
                                                ("convnext", "baseline", "image_encoder"),
                                                ("connext_full", "connext", "image_encoder")])
def test_convert_weights_refuses_a_dest_the_family_lacks(kind, family, dest):
    with pytest.raises(ValueError, match="holds no"):
        tcw.main(["--kind", kind, "--family", family, "--dest", dest, "--input", "unread.pth", "--output", "x.pt"])


def test_convert_weights_names_a_missing_key(sources, tmp_path):
    path, _, _ = sources["bert-baseline"]
    sd = torch.load(path)
    del sd["bert.encoder.layer.1.output.dense.bias"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(ValueError, match="encoder.layer.1.output.dense.bias"):
        tcw.main(["--kind", "bert", "--num_layers", "2", "--dest", "text_encoder", "--input",
                  str(tmp_path / "short.pth"), "--output", str(tmp_path / "x.pt")])


# --------------------------------------------------------------------------- reference ConNexT checkpoints
def _connext(head, mamba=False):
    return tconnext.ConNexTClassifier(tconnext.ConNexTConfig(
        convnext_variant="port_pico", fusion_dim=32, head=head, moe_expert_layers=(32, 16, 7), use_mamba_fusion=mamba,
        llm_hidden_dim=24, bert=tbert.BertConfig(**BERT)))


def _layouts(sd):
    tower = {k: v for k, v in sd.items() if k.startswith("image_encoder.")}
    tv = {k: v for k, v in sd.items() if not k.startswith("image_encoder.")}
    tv.update(_torchvision({k[len("image_encoder."):]: v for k, v in tower.items()}, "image_encoder."))
    return {"bare": sd, "net.net.": {"net.net." + k: v for k, v in sd.items()},
            "net.": {"net." + k: v for k, v in sd.items()}, "torchvision": tv,
            "net.net.+torchvision": {"net.net." + k: v for k, v in tv.items()}}


@pytest.mark.parametrize("head", ["linear", "moe"])
@pytest.mark.parametrize("layout", ["bare", "net.net.", "net.", "torchvision", "net.net.+torchvision"])
def test_a_reference_connext_file_loads_as_convert_connext_full_reads_it(head, layout, tmp_path):
    sd = _seeded(_connext(head), 21).state_dict()
    ref = _layouts(sd)[layout]
    ref = {**ref, "pooler_junk.weight": torch.ones(2)} if layout == "bare" else ref
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": ref, "epoch": 3}, path)  # a Lightning checkpoint
    params, _, kan = convert_connext_full({k: v.numpy() for k, v in ref.items()}, head=head,
                                          convnext_variant="port_pico", num_bert_layers=2, moe_num_experts=4)
    want = tconvert.connext_state_dict_from_jax(params, kan or None)
    model = _seeded(_connext(head), 22)
    load_weights(model, path, "connext")
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v) and torch.equal(got[k], sd[k]), k


def test_a_reference_connext_file_that_lacks_a_key_raises(tmp_path):
    sd = _layouts(_seeded(_connext("moe"), 23).state_dict())["net.net.+torchvision"]
    for missing in ("net.net.image_encoder.features.3.1.block.3.weight", "net.net.moe.w_gate",
                    "net.net.text_encoder.bert.encoder.layer.1.attention.self.key.bias"):
        torch.save({k: v for k, v in sd.items() if k != missing}, tmp_path / "short.pth")
        with pytest.raises(ValueError, match="does not look like a ConNexT"):
            load_weights(_connext("moe"), str(tmp_path / "short.pth"), "connext")


def test_a_mamba_fusion_model_refuses_a_reference_connext_file_but_reads_its_own(tmp_path):
    torch.save(_seeded(_connext("linear"), 24).state_dict(), tmp_path / "ref.pth")
    model = _seeded(_connext("linear", mamba=True), 25)
    with pytest.raises(ValueError, match="mamba-fusion model"):
        load_weights(model, str(tmp_path / "ref.pth"), "connext")
    from mdhs_tpu_torch.core.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path / "own.pt"), model)
    fresh = _seeded(_connext("linear", mamba=True), 26)
    load_weights(fresh, str(tmp_path / "own.pt"), "connext")
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in model.state_dict().items())


def test_a_torchvision_convnext_tower_loads_as_pretrained(tmp_path):
    """``model.image_encoder.pretrained_path`` of a torchvision ConvNeXt: the HF tower's tensors."""
    hf = _seeded(tconvnext.ConvNeXt("port_pico"), 27).state_dict()
    torch.save({**_torchvision(hf), "classifier.2.weight": torch.ones(3, 40)}, tmp_path / "tv.pth")
    model = _seeded(_connext("linear"), 28)
    load_pretrained(model, Config({"model": {"image_encoder": {"pretrained_path": str(tmp_path / "tv.pth")}}}),
                    "connext")
    got = model.state_dict()
    assert all(torch.equal(got["image_encoder." + k], v) for k, v in hf.items())
