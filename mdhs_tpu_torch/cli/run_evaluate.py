"""Evaluation CLI: accuracy and the full metric report on a labeled test split.

Counterpart of ``mdhs_tpu/cli/run_evaluate.py`` (the same JSON fields), on the
card (``--device cuda``, the default) or the CPU (``--device cpu``):

    python3 -m mdhs_tpu_torch.cli.run_evaluate --config CFG --model_path CKPT \\
        --image_dir DIR --json_path DESCRIPTIONS.json --label_csv LABELS.csv [--report_json report.json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import add_device_argument
from ..train.metrics import classification_report
from .common import build_predictor, run_prediction


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate on a labeled test set")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--json_path", type=str, default=None)
    p.add_argument("--label_csv", type=str, default=None)
    p.add_argument("--family", type=str, default="baseline", choices=["baseline", "mibf", "connext"])
    p.add_argument("--report_json", type=str, default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[])
    add_device_argument(p)
    args = p.parse_args(argv)

    predictor = build_predictor(args.config, family=args.family, overrides=args.overrides, device=args.device)
    predictor.load_weights(args.model_path)
    loader = predictor.make_test_loader(args.image_dir, args.json_path, args.label_csv)
    ids, preds, logits = run_prediction(predictor, loader)
    labels = np.asarray([m["label"] for m in loader.dataset.metadata], np.int32)

    num_classes = predictor.cfg.get("model.num_classes", 7)
    report = classification_report(torch.from_numpy(logits), torch.from_numpy(labels), num_classes)
    out = {
        "accuracy": float(report["accuracy"]) * 100.0,
        "accuracy_macro": float(report["accuracy_macro"]),
        "precision_macro": float(report["precision_macro"]),
        "recall_macro": float(report["recall_macro"]),
        "f1_macro": float(report["f1_macro"]),
        "auroc_macro": float(report["auroc_macro"]),
        "per_class_f1": report["per_class"]["f1"].tolist(),
        "confusion_matrix": report["confusion_matrix"].int().tolist(),
        "num_samples": len(ids),
    }
    print(json.dumps(out, indent=2))
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
