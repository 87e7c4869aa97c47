"""The entry points: ``python3 -m mdhs_tpu_torch.cli.run_predict``, ``run_evaluate``, ``run_ablation_eval``,
``run_analysis``, ``run_train``, ``export_serving``, ``run_serve`` and ``convert_weights``."""
