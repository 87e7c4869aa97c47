"""Analysis CLI: Grad-CAM overlays and the feature-rank spectrum of a baseline model.

Counterpart of ``mdhs_tpu/cli/run_analysis.py`` (reference
run_analysis_cli.py / scripts/run_analysis.py:28-241), on the card (``--device
cuda``, the default) or the CPU (``--device cpu``):

    python3 -m mdhs_tpu_torch.cli.run_analysis --config CFG --model_path CKPT \\
        --image_dir DIR --json_path DESCRIPTIONS.json --output_dir analysis_out [--num_cam_images 20]

Over the test split (the baseline family, as in JAX): each batch's fused
features (``forward_features`` in inference mode, its first ``n_valid`` rows)
go to the rank analyzer; until ``num_cam_images`` overlays are written, each
batch also takes one Grad-CAM step (``cam_step``: the forward through
``logits_and_taps`` with zero perturbations at the tower's taps, the text
tower without a graph, and ``torch.autograd.grad`` over the perturbations
alone) on its own eval-preprocessed images, made outside inference mode so
that autograd can take them. Each overlay is the JET CAM over the center crop
of the uint8 canvas, written as ``cam_{image_id}.png`` by ``data/png.py``
(the JAX CLI writes ``.jpg`` through PIL); ``feature_rank.png`` where
matplotlib is installed. Prints the JAX CLI's last line and returns the
spectrum (``analysis/feature_rank.py``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..analysis.feature_rank import FeatureRankAnalyzer
from ..analysis.gradcam import gradcam_device, visualize_cam
from ..data.png import write_png
from ..device import add_device_argument
from ..ops.preprocess import eval_pipeline
from .common import build_predictor


def batch_inputs(batch: dict, model, device: torch.device, image_size: int) -> tuple:
    """(images, input_ids, attention_mask, tabular or None) of a loader batch on
    ``device``: the uint8 canvases center-cropped and normalised as the model
    takes them (``eval_pipeline``), in its input dtype, outside inference mode."""
    images = eval_pipeline(torch.from_numpy(batch["image"]).to(device), image_size,
                           normalize=model.normalize_input, dtype=model.input_dtype)
    ids, mask = (torch.from_numpy(np.asarray(batch[k], np.int64)).to(device) for k in ("input_ids", "attention_mask"))
    tab = batch.get("tabular")
    return images, ids, mask, None if tab is None else torch.from_numpy(np.asarray(tab, np.float32)).to(device)


def cam_step(model, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             tabular: Optional[torch.Tensor] = None, image_size: int = 224):
    """One Grad-CAM step of a batch: (cams (B, S, S) float32 in [0, 1], logits)."""
    return gradcam_device(lambda p: model.logits_and_taps(images, input_ids, attention_mask, tabular, perturbations=p),
                          image_size=image_size)


def center_crop01(canvas: np.ndarray, size: int) -> np.ndarray:
    """A uint8 (H, W, 3) canvas as float32 in [0, 1], center-cropped to size x size."""
    img01 = canvas.astype(np.float32) / 255.0
    y0, x0 = (img01.shape[0] - size) // 2, (img01.shape[1] - size) // 2
    return img01[y0:y0 + size, x0:x0 + size]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Grad-CAM + feature rank analysis")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--json_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="analysis_out")
    p.add_argument("--num_cam_images", type=int, default=20)
    p.add_argument("--set", dest="overrides", action="append", default=[])
    add_device_argument(p)
    args = p.parse_args(argv)

    predictor = build_predictor(args.config, family="baseline", overrides=args.overrides, device=args.device)
    predictor.load_weights(args.model_path)
    loader = predictor.make_test_loader(args.image_dir, args.json_path)
    os.makedirs(args.output_dir, exist_ok=True)
    model, size = predictor.model, predictor.image_size
    rank = FeatureRankAnalyzer()
    n_cam_done = 0
    for batch in loader:
        images, ids, mask, tab = batch_inputs(batch, model, predictor.device, size)
        n = int(batch["n_valid"])
        with torch.inference_mode():
            feats = model.forward_features(images, ids, mask, tabular=tab)
        rank.add(feats.float().cpu().numpy()[:n])
        if n_cam_done < args.num_cam_images:
            cams = cam_step(model, images, ids, mask, tab, size)[0].cpu().numpy()
            take = min(n, args.num_cam_images - n_cam_done)
            for i in range(take):
                overlay = visualize_cam(center_crop01(batch["image"][i], size), cams[i])
                write_png(os.path.join(args.output_dir, f"cam_{batch['image_id'][i]}.png"), overlay)
            n_cam_done += take

    result = rank.compute()
    rank.plot(os.path.join(args.output_dir, "feature_rank.png"))
    print(f"effective rank: {result['effective_rank']:.1f}; "
          f"rank@1%: {result['rank_at_1pct']}; CAMs written: {n_cam_done}")
    return result


if __name__ == "__main__":
    main()
