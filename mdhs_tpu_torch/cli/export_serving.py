"""Serving export: the served step frozen into one artifact with ``torch.export``.

Counterpart of ``mdhs_tpu/cli/export_serving.py``, on the card (``--device
cuda``, the default) or the CPU (``--device cpu``):

    python3 -m mdhs_tpu_torch.cli.export_serving --config CFG [--model_path CKPT] --family mibf \\
        --batch_size 512 --output model.pt2 [--tta] [--smoke_test]

``export_forward`` exports ``serving.py::ServeFunction`` of the model, the
module the live ``ServingModel`` runs: the eval preprocessing on the device,
the forward and, with ``--tta``, the fused TTA over hflip, vflip and rot90,
under ``torch.no_grad()`` at its static input spec: ``image`` uint8 ``(B,
canvas, canvas, 3)``, ``input_ids`` and ``attention_mask`` int64 ``(B,
tokenizer.max_length)``, and for a baseline with the tabular branch
``tabular`` float32 ``(B, width)``, the width of the metadata CSV's vectors
(``mdhs_tpu/cli/export_serving.py:62-65``). As in JAX, the image is 4-D for
every configuration: a sequence or multi-view configuration's artifact takes
one image a record and never runs its sequence encoder. The hand-written kernels are the ``torch.ops.mdhs``
custom ops (``ops/_library.py``), so the program holds them as nodes and
launches them when it runs. One eager forward before the trace makes the
weight caches the live model keeps (the int8 weights of each BERT layer, the
stacked MoE bank, the ImageNet statistics); the trace reads them, so the
artifact carries them as constants and a request remakes none of them. (The
JAX artifact carries the float weights and quantizes inside its graph; the
int8 bits are the same, ``ops/quant.py::quantize_weight`` being bit-exact with
JAX.)

The artifact is ``torch.export.save``'s archive (the example inputs left out)
with ``meta.json`` beside the program: the format tag, the device type, the
family, the static batch, the input spec, the TTA transforms and what the
loader reports of the model (``serving.py::read_meta``). ``main`` prints the
JAX CLI's keys, the device in place of ``platforms``, and the export's
seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from ..core.config import load_config
from ..device import add_device_argument, resolve_device
from ..serving import FORMAT, META, ServeFunction, ServingModel
from .common import Predictor

TTA = ("hflip", "vflip", "rot90")


def input_spec(batch_size: int, canvas: int, seq_len: int, tabular_dim: int = 0) -> dict:
    """The static inputs {name: (shape, dtype)} of a served step."""
    spec = {"image": ((batch_size, canvas, canvas, 3), "uint8"),
            "input_ids": ((batch_size, seq_len), "int64"),
            "attention_mask": ((batch_size, seq_len), "int64")}
    if tabular_dim:
        spec["tabular"] = ((batch_size, tabular_dim), "float32")
    return spec


def export_program(fn: ServeFunction, spec: dict, device: torch.device) -> torch.export.ExportedProgram:
    """``fn`` exported at ``spec`` on ``device``, after the eager forward that makes
    the caches the trace reads."""
    args = tuple((torch.ones if name == "attention_mask" else torch.zeros)(shape, dtype=getattr(torch, dt),
                                                                           device=device)
                 for name, (shape, dt) in spec.items())
    with torch.no_grad():
        fn(*args)
        exported = torch.export.export(fn, args)
    exported.example_inputs = None  # the spec is in meta.json: no batch of zeros in the file
    return exported


def export_forward(predictor: Predictor, batch_size: int, tta=()):
    """(the exported program, its input spec, the exported ``ServeFunction``) of
    the predictor's served step at a static batch of ``batch_size``."""
    spec = input_spec(batch_size, int(predictor.cfg.get("data.canvas", 256)),
                      int(predictor.cfg.get("tokenizer.max_length", 128)), predictor.tabular_dim)
    model = predictor.model.to(memory_format=torch.channels_last).eval()
    fn = ServeFunction(model, predictor.image_size, tta)
    return export_program(fn, spec, predictor.device), spec, fn


def write_artifact(path: str, exported: torch.export.ExportedProgram, fn: ServeFunction, spec: dict,
                   device: torch.device, family: str) -> dict:
    """Write the archive, its meta.json made from the exported ``fn`` and its
    spec; returns the meta and the sizes."""
    meta = {"format": FORMAT, "device": torch.device(device).type, "family": family,
            "batch_size": spec["image"][0][0], "inputs": {k: [list(shape), dt] for k, (shape, dt) in spec.items()},
            "tta": list(fn.tta), "image_size": fn.image_size, "normalize": bool(fn.normalize),
            "image_dtype": str(fn.dtype).removeprefix("torch.")}
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with warnings.catch_warnings():
        # channels_last convolution weights are not contiguous, so the archive keeps each one's
        # whole storage with its strides (it warns so); they load back channels_last
        warnings.filterwarnings("ignore", message="No complete tensor found in the group")
        torch.export.save(exported, path, extra_files={META: json.dumps(meta)})
    tensors = [t for t in (*exported.state_dict.values(), *exported.constants.values()) if isinstance(t, torch.Tensor)]
    return {"meta": meta, "bytes": os.path.getsize(path),
            "weight_bytes": sum(t.numel() * t.element_size() for t in tensors)}


def main(argv=None):
    p = argparse.ArgumentParser(description="Export a serving artifact")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--family", type=str, default="baseline", choices=["baseline", "mibf", "connext"])
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--tta", action="store_true", help="bake fused TTA (hflip/vflip/rot90) into the artifact")
    p.add_argument("--smoke_test", action="store_true", help="load the written artifact and run one batch")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    add_device_argument(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config, overrides=args.overrides)
    predictor = Predictor(cfg, family=args.family, device=device)
    if args.model_path:
        predictor.load_weights(args.model_path)
    t0 = time.perf_counter()
    exported, spec, fn = export_forward(predictor, args.batch_size, TTA if args.tta else ())
    seconds = time.perf_counter() - t0
    written = write_artifact(args.output, exported, fn, spec, device, args.family)

    info = {"output": args.output, "format": FORMAT, "bytes": written["bytes"], "weight_bytes": written["weight_bytes"],
            "device": device.type, "batch_size": args.batch_size, "inputs": written["meta"]["inputs"],
            "seconds": seconds}
    if args.smoke_test:
        rng = np.random.default_rng(0)
        batch = {k: rng.integers(0, 2, shape).astype(dt) for k, (shape, dt) in spec.items()}
        logits = ServingModel.load(args.output, device).predict(batch)
        info["smoke_logits_shape"] = list(logits.shape)
        info["smoke_finite"] = bool(np.isfinite(logits).all())
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
