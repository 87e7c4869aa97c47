"""Feature-rank (SVD spectrum) analysis of fusion features.

Counterpart of ``mdhs_tpu/analysis/feature_rank.py`` (reference
analysis_tools.py:142-195), in numpy on the host: collect the fused features
over a dataset, center them, take their singular values, and report them
normalised by the largest, the effective rank (the exponential of the
entropy of the singular values' distribution) and the count above 1 % of
the largest; ``plot`` draws the normalised spectrum on a log scale where
matplotlib is installed, and returns None where it is not.
"""

from __future__ import annotations

import numpy as np


class FeatureRankAnalyzer:
    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def add(self, features) -> None:
        self._chunks.append(np.asarray(features, np.float32))

    def compute(self) -> dict:
        if not self._chunks:
            raise ValueError("no features collected")
        feats = np.concatenate(self._chunks, axis=0)
        centered = feats - feats.mean(axis=0, keepdims=True)
        s = np.linalg.svd(centered, compute_uv=False)
        s_norm = s / max(s.max(), 1e-12)
        p = s / max(s.sum(), 1e-12)
        entropy = -(p * np.log(p + 1e-12)).sum()
        return {
            "singular_values": s,
            "normalized": s_norm,
            "effective_rank": float(np.exp(entropy)),
            "rank_at_1pct": int((s_norm > 0.01).sum()),
        }

    def plot(self, out_path: str):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        res = self.compute()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.semilogy(res["normalized"])
        ax.set_xlabel("index")
        ax.set_ylabel("normalized singular value")
        ax.set_title(f"effective rank = {res['effective_rank']:.1f}")
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
