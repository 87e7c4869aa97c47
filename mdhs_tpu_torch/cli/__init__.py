"""The eval entry points: ``python3 -m mdhs_tpu_torch.cli.run_predict``, ``run_evaluate``, ``run_ablation_eval``."""
