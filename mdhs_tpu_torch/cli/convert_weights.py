"""Convert reference torch checkpoints into port checkpoints.

Counterpart of ``mdhs_tpu/cli/convert_weights.py``: a torchvision ResNet, an HF
BERT, a ConvNeXt (HF ``ConvNextModel`` or torchvision ``features.*``) or a whole
reference ConNexT becomes a port checkpoint (``core/checkpoint.py::save_state``:
``state_dict`` and ``metadata``) holding what the JAX converter reads, under the
port's names, which ``run_predict --model_path`` / ``model.pretrained_path``
merge tolerantly (the tensors of the model it does not hold are left as they
are, as the JAX CLI's msgpack is merged).

The JAX CLI nests its tree under ``--dest``, a slash path of the JAX model
(``resnet`` under ``<dest>/trunk``, ``bert`` under ``<dest>/bert``); the port
writes names, so that path is mapped to the prefix its subtree has in the
family's port model (``--family``, ``baseline`` by default, as the other CLIs
take it). A path where the family's model holds no network of that kind
raises, naming the paths it has:

    python3 -m mdhs_tpu_torch.cli.convert_weights --kind resnet --backbone resnet18 \\
        --input resnet18.pth --dest image_encoder --output resnet18_port.pt
    python3 -m mdhs_tpu_torch.cli.convert_weights --kind connext_full --family connext --head moe \\
        --input model.ckpt --output connext_port.pt
"""

from __future__ import annotations

import argparse

from ..core import convert
from ..core.checkpoint import host_state_dict, load_torch_file, save_state

KINDS = ("resnet", "resnet_classifier", "bert", "convnext", "connext_full")
# the key a kind's JAX tree nests its network under, below --dest, and what network that is
_KIND_TREE = {"resnet": ("trunk", "ResNet trunk"), "resnet_classifier": ("", "ResNet classifier"),
              "bert": ("bert", "BertModel"), "convnext": ("", "ConvNeXt"), "connext_full": ("", "ConNexT")}
# each family's JAX subtrees that hold such a network: path -> (the port's prefix, the network)
SUBTREES = {
    "baseline": {"image_encoder/trunk": ("image_encoder.model.", "ResNet trunk"),
                 "text_encoder/bert": ("text_encoder.model.", "BertModel")},
    "mibf": {"image_encoder": ("image_encoder.", "ResNet classifier"),
             "image_encoder/trunk": ("image_encoder.", "ResNet trunk")},
    "connext": {"image_encoder": ("image_encoder.", "ConvNeXt"), "": ("", "ConNexT")},
}


def port_prefix(kind: str, family: str, dest: str) -> str:
    """The prefix, in ``family``'s port model, of the subtree the JAX CLI's ``kind``
    tree lands in under ``dest``; ValueError where that subtree holds no such network."""
    nest, network = _KIND_TREE[kind]
    path = "/".join(p for p in (*dest.split("/"), nest) if p)
    prefix, held = SUBTREES[family].get(path, (None, None))
    if held != network:
        have = ", ".join(f"{p or '(the root)'}: {n}" for p, n in SUBTREES[family].items())
        raise ValueError(f"--dest {dest!r}: the {kind} tree would sit at {path or '(the root)'!r}, where the "
                         f"'{family}' model holds no {network} (its subtrees: {have})")
    return prefix


def convert_state_dict(kind: str, sd, *, backbone: str = "resnet18", variant: str = "base", num_layers: int = 12,
                       head: str = "linear") -> dict:
    """What the JAX converter of ``kind`` reads from ``sd``, under the port's names
    (relative to the network's root)."""
    if kind == "resnet":
        return convert.resnet_from_torchvision(sd, backbone)
    if kind == "resnet_classifier":
        return convert.resnet_from_torchvision(sd, backbone, classifier=True)
    if kind == "bert":
        return convert.bert_from_hf(sd, num_layers)
    if kind == "convnext":
        return convert.convnext_from_reference(sd, variant)
    if kind == "connext_full":
        # Lightning Model4AAAI_MoE / OurClassfierConvnextV2 checkpoints (reference ConNexT/predict.py:53-57)
        return convert.connext_from_reference(sd, head=head, convnext_variant=variant, num_bert_layers=num_layers)
    raise ValueError(f"unknown kind: {kind}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="reference torch -> mdhs_tpu_torch weight conversion")
    p.add_argument("--kind", required=True, choices=list(KINDS))
    p.add_argument("--input", required=True, help=".pth/.bin/.ckpt/.safetensors file")
    p.add_argument("--output", required=True, help="output port checkpoint (.pt)")
    p.add_argument("--family", default="baseline", choices=sorted(SUBTREES))
    p.add_argument("--backbone", default="resnet18")
    p.add_argument("--variant", default="base")
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--head", default="linear", choices=["linear", "moe"],
                   help="connext_full classifier head to map (fc vs MoE bank)")
    p.add_argument("--dest", default="",
                   help="the JAX model's slash-separated subtree the tree nests under, e.g. 'image_encoder' or "
                        "'text_encoder'; mapped to its prefix in the family's port model")
    args = p.parse_args(argv)
    prefix = port_prefix(args.kind, args.family, args.dest)
    sd = load_torch_file(args.input)
    try:
        tensors = convert_state_dict(args.kind, sd, backbone=args.backbone, variant=args.variant,
                                     num_layers=args.num_layers, head=args.head)
    except KeyError as exc:
        raise ValueError(f"{args.input} does not look like a {_KIND_TREE[args.kind][1]} state dict for "
                         f"--kind {args.kind} (missing key {exc})") from exc
    state = {"state_dict": host_state_dict({prefix + k: v for k, v in tensors.items()}),
             "metadata": {"converted_from": args.input, "kind": args.kind, "family": args.family,
                          "dest": args.dest}}
    save_state(args.output, state)
    print(f"converted {len(sd)} torch tensors -> {args.output}")
    return state


if __name__ == "__main__":
    main()
