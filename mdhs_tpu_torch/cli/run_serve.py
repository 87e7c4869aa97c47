"""Artifact serving CLI: an exported artifact -> submission CSV.

Counterpart of ``mdhs_tpu/cli/run_serve.py``, on the card (``--device
cuda``, the default) or the CPU (``--device cpu``, for a CPU artifact):

    python3 -m mdhs_tpu_torch.cli.run_serve --artifact model.pt2 --config CFG \\
        [--image_dir DIR --json_path DESCRIPTIONS.json] --output_path submission.csv [--family mibf]

No model code: the config is read only for the data paths and the tokenizer,
and the artifact (``cli/export_serving.py``) fixes everything about the model,
its static batch, canvas and tokenizer length among it. The request loop is
``ServingModel.predict_stream``, so batch k+1's staging and host-to-device
copy overlap batch k's forward. ``--family`` is the data convention (``mibf``
strips CJK text, as the trainer's loaders do). This module imports neither the
models nor yaml nor msgpack (a JSON config needs neither).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.config import load_config
from ..data.datasets import DatasetOptions, MultimodalDataset
from ..data.loader import DataLoader
from ..data.tokenizer import load_tokenizer
from ..device import add_device_argument
from ..serving import ServingModel
from .submission import write_submission


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve predictions from an exported artifact")
    p.add_argument("--artifact", type=str, required=True, help="path written by cli/export_serving.py")
    p.add_argument("--config", type=str, required=True, help="config for data paths + tokenizer (model section unused)")
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--json_path", type=str, default=None)
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--depth", type=int, default=2, help="max in-flight requests in the pipelined loop")
    p.add_argument("--family", type=str, default="baseline", choices=["baseline", "mibf", "connext"],
                   help="data-convention family (mibf strips CJK text, matching the trainer's loaders)")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    add_device_argument(p)
    args = p.parse_args(argv)

    cfg = load_config(args.config, overrides=args.overrides)
    model = ServingModel.load(args.artifact, args.device)
    tokenizer = load_tokenizer(cfg.get("model.text_encoder.model_name"),
                               vocab_size=cfg.get("model.text_encoder.vocab_size", 30522))
    d = cfg.get("data")
    # the artifact's static shapes rule, and its image is one canvas a record: no stacked mode or
    # LLM hidden states, as JAX's run_serve reads the test split
    opts = DatasetOptions.from_config(cfg, args.family, "test", max_length=int(model.input_spec["input_ids"][0][1]),
                                      canvas=int(model.input_spec["image"][0][1]),
                                      tabular_enabled="tabular" in model.input_spec, pseudo_2p5d=False,
                                      sequence=False, multi_view=False, llm_hidden_json=None)
    ds = MultimodalDataset(args.image_dir or d.get("test_image_dir"), args.json_path or d.get("test_json_path"),
                           d.get("test_label_csv"), tokenizer, opts)
    loader = DataLoader(ds, batch_size=model.batch_size)

    ids, preds = [], []

    def requests():
        for batch in loader:
            n = int(batch["n_valid"])
            ids.extend(batch["image_id"][:n])
            yield {k: np.asarray(batch[k])[:n] for k in model.input_spec}

    for logits in model.predict_stream(requests(), depth=args.depth):
        preds.extend(logits.argmax(-1).tolist())

    write_submission(args.output_path, ids, preds)
    print(f"served {len(ids)} predictions from {args.artifact} -> {args.output_path}")
    return ids, preds


if __name__ == "__main__":
    main()
