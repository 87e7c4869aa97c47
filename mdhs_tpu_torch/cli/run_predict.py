"""Prediction CLI -> submission CSV.

Counterpart of ``mdhs_tpu/cli/run_predict.py``, on the card (``--device cuda``,
the default) or the CPU (``--device cpu``):

    python3 -m mdhs_tpu_torch.cli.run_predict --config CFG --model_path CKPT \\
        --image_dir DIR --json_path DESCRIPTIONS.json --output_path submission.csv [--family mibf]

TTA runs where the config's ``inference.tta.enabled`` asks for it.
``main`` returns {"image_ids", "predictions", "logits"}.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np
import torch

from ..device import add_device_argument
from ..train.metrics import auroc_ovr_macro
from .common import build_predictor, run_prediction
from .submission import write_submission


def main(argv=None, family: str = "baseline"):
    p = argparse.ArgumentParser(description="Predict labels for a test set")
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--json_path", type=str, default=None)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--family", type=str, default=family, choices=["baseline", "mibf", "connext"])
    p.add_argument("--save_probs", type=str, default=None,
                   help="also write per-class softmax probabilities as a CSV")
    p.add_argument("--compute_auc", action="store_true",
                   help="print the macro one-vs-rest AUC when the test split has labels")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    add_device_argument(p)
    args = p.parse_args(argv)

    predictor = build_predictor(args.config, family=args.family, overrides=args.overrides, device=args.device)
    predictor.load_weights(args.model_path)
    loader = predictor.make_test_loader(args.image_dir, args.json_path)
    ids, preds, logits = run_prediction(predictor, loader, tta_cfg=predictor.cfg.get("inference.tta", {}))
    write_submission(args.output_path, ids, preds)
    if args.save_probs or args.compute_auc:
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
    if args.save_probs:
        with open(args.save_probs, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image_id"] + [f"prob_{i}" for i in range(probs.shape[1])])
            for i, row in zip(ids, probs):
                w.writerow([i] + [f"{p_:.6f}" for p_ in row])
    if args.compute_auc:
        labels = list(getattr(loader.dataset, "labels", []) or [])
        if labels and min(labels) >= 0:
            auc = float(auroc_ovr_macro(torch.from_numpy(probs), torch.as_tensor(labels[: len(probs)]),
                                        probs.shape[1]))
            print(f"Macro AUC: {auc:.4f}")
        else:
            print("AUC computation skipped: no labels in the test split")
    print(f"wrote {len(ids)} predictions to {args.output_path}")
    return {"image_ids": ids, "predictions": preds, "logits": logits}


if __name__ == "__main__":
    main()
