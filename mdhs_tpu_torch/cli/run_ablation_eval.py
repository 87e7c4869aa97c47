"""Ablation CLI: full_fusion / image_only / text_off accuracy of a baseline model.

Counterpart of ``mdhs_tpu/cli/run_ablation_eval.py``, on the card
(``--device cuda``, the default) or the CPU (``--device cpu``):

    python3 -m mdhs_tpu_torch.cli.run_ablation_eval --config CFG --model_path CKPT \\
        --image_dir DIR --json_path DESCRIPTIONS.json --label_csv LABELS.csv [--output results.yml]

TTA runs where the config asks for it. The results go to ``--output``, or to
``ablation_{timestamp}.yml`` in the run directory
(``{output.log_dir}/{output.run_name}_{timestamp}``), as YAML that this module
writes itself (a machine may have no yaml writer) and that
``yaml.safe_load`` reads to the dict the JAX CLI writes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from datetime import datetime

import numpy as np

from ..device import add_device_argument
from .common import build_predictor, run_prediction

MODES = {"full_fusion": None, "image_only": "image_only", "text_off": "text_off"}


def _yaml_scalar(v) -> str:
    """A str, int or float as a YAML scalar that reads back to itself (a JSON
    string is a YAML double-quoted scalar)."""
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        return repr(v)
    if isinstance(v, (bool, int)):
        return json.dumps(v)
    return json.dumps(str(v), ensure_ascii=False)


def dump_results(path: str, model_path: str, results: dict) -> None:
    """{"model_path": ..., "results": {mode: accuracy}} as block YAML."""
    lines = [f"model_path: {_yaml_scalar(model_path)}", "results:"]
    lines += [f"  {name}: {_yaml_scalar(acc)}" for name, acc in results.items()]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(description="Ablation evaluation")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--json_path", type=str, default=None)
    p.add_argument("--label_csv", type=str, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[])
    add_device_argument(p)
    args = p.parse_args(argv)

    predictor = build_predictor(args.config, family="baseline", overrides=args.overrides, device=args.device)
    predictor.load_weights(args.model_path)
    loader = predictor.make_test_loader(args.image_dir, args.json_path, args.label_csv)
    labels = np.asarray([m["label"] for m in loader.dataset.metadata], np.int32)
    tta_cfg = predictor.cfg.get("inference.tta", {})

    results = {}
    for name, mode in MODES.items():
        _, preds, _ = run_prediction(predictor, loader, tta_cfg=tta_cfg, ablation_mode=mode)
        acc = 100.0 * float((np.asarray(preds) == labels).mean())
        results[name] = round(acc, 4)
        print(f"{name}: {acc:.2f}%")

    out_path = args.output or os.path.join(predictor.output_dir,
                                           f"ablation_{datetime.now().strftime('%Y%m%d_%H%M%S')}.yml")
    dump_results(out_path, args.model_path, results)
    print(f"results written to {out_path}")
    return results


if __name__ == "__main__":
    main()
