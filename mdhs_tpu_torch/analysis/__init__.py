"""Analysis of a trained baseline model: Grad-CAM over the image tower's taps
(``gradcam``) and the feature-rank spectrum of the fused features
(``feature_rank``); ``cli/run_analysis.py`` runs both over a test split."""
