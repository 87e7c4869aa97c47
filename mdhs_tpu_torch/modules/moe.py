"""Sparsely gated Mixture-of-Experts with KAN experts, eval forward.

Counterpart of ``mdhs_tpu/modules/moe.py``: top-k gating on the softmaxed
logits with the renormalised top-k probabilities, the cv^2 balance loss, and
the dense expert bank (every expert runs on the whole batch; the gates,
zero for experts not chosen, combine the outputs). The JAX package vmaps a
KAN over a stacked parameter bank; here the expert axis is written out: each
KAN layer of the bank is one ``kan_forward`` launch over all experts, with
layer 0's input shared by them. The stacked operands of each layer (grids,
base weights, scaled spline weights) are made once and kept, and made again
only when a parameter or grid has changed (``stacked_layers``). State-dict names are the reference's
(``w_gate``, ``w_noise``, ``experts.{e}.layers.{i}.{base_weight,
spline_weight,spline_scaler,grid}``), which
``mdhs_tpu.core.convert._convert_kan_bank`` reads.

Top-k takes the lowest index among equal probabilities, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` promises no
order on ties), so the zero-initialised ``w_gate`` routes as in JAX. The
gating is float32. Training (the noisy gating and its load estimator) raises
until the baseline training path (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import kan_spline as _ks
from .kan import KAN


def cv_squared(x: torch.Tensor) -> torch.Tensor:
    """Squared coefficient of variation, var (ddof 1) / (mean^2 + 1e-10)."""
    x = x.float()
    if x.shape[0] == 1:
        return x.new_zeros(())
    return x.var(correction=1) / (x.mean() ** 2 + 1e-10)


def noisy_top_k_gating(x, w_gate, w_noise, k: int, *, train: bool = False):
    """(gates (B, E), load (E,)) of the eval branch: clean logits, softmax,
    top-k, renormalised; load counts the rows that chose each expert."""
    if train:
        raise NotImplementedError("noisy_top_k_gating(train=True): the baseline training path, "
                                  "ROADMAP Queue 1 item 10")
    probs = torch.softmax(x.float() @ w_gate.float(), dim=1)
    top_probs, top_idx = torch.sort(probs, dim=1, descending=True, stable=True)
    top_k_probs = top_probs[:, :k]
    top_k_gates = top_k_probs / (top_k_probs.sum(dim=1, keepdim=True) + 1e-6)
    gates = torch.zeros_like(probs).scatter(1, top_idx[:, :k], top_k_gates)
    return gates, (gates > 0).float().sum(dim=0)


class MoE(nn.Module):
    """``forward(x)`` returns (logits (B, output_size) float32, balance loss)."""

    def __init__(self, input_size: int, output_size: int, num_experts: int = 4, k: int = 4,
                 expert_layers: Sequence[int] | None = None, grid_size: int = 5, spline_order: int = 3,
                 loss_coef: float = 1e-2, device=None, dtype=None):
        super().__init__()
        if k > num_experts:
            raise ValueError("k must be <= num_experts")
        f32 = dict(device=device, dtype=torch.float32)
        self.k, self.loss_coef = k, loss_coef
        self.out_dtype = dtype or torch.get_default_dtype()
        layers = tuple(expert_layers or (input_size, 512, 128, 32, output_size))
        self.w_gate = nn.Parameter(torch.zeros((input_size, num_experts), **f32))
        self.w_noise = nn.Parameter(torch.zeros((input_size, num_experts), **f32))
        self.experts = nn.ModuleList(KAN(layers, grid_size, spline_order, device=device, dtype=dtype)
                                     for _ in range(num_experts))
        # the stacked bank (stacked_layers): plain attributes, not buffers, so state_dict
        # keeps the converter's keys
        self._bank: list | None = None
        self._bank_made_from: tuple = ()

    def _stack(self) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        return [(torch.stack([l.grid for l in bank]), torch.stack([l.base_weight for l in bank]),
                 torch.stack([l.scaled_spline_weight() for l in bank]))
                for bank in zip(*(e.layers for e in self.experts))]

    def stacked_layers(self) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Each KAN layer's (grids, base weights, scaled spline weights) stacked
        over the experts, float32, as ``kan_forward`` takes them. Kept, and made
        again whenever a parameter or grid has changed since they were made: a
        move or load_state_dict changes a tensor's storage, an in-place update its
        version counter. The values are the stack of each layer's own ``grid``,
        ``base_weight`` and ``scaled_spline_weight()``, bit for bit. Stacked anew
        on each call where a kept stack would be wrong: with gradients on for a
        tensor that takes them (so that they reach the parameters), and where a
        tensor is an inference tensor (no version counter shows its updates).
        While ``torch.export`` traces, the kept stack is returned as it is (the
        trace's parameters have no storage to compare): the exported program
        holds it as constants, made by an eager forward before the trace."""
        if torch.compiler.is_exporting():
            if self._bank is None:
                raise RuntimeError("MoE.stacked_layers: no stacked bank kept to export; run one eager forward "
                                   "before torch.export")
            return self._bank
        tensors = [t for e in self.experts for layer in e.layers
                   for t in (layer.grid, layer.base_weight, layer.spline_weight, layer.spline_scaler)]
        if any(t.is_inference() or (t.requires_grad and torch.is_grad_enabled()) for t in tensors):
            return self._stack()
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if self._bank is None or key != self._bank_made_from:
            with torch.inference_mode(False), torch.no_grad():
                self._bank = self._stack()
            self._bank_made_from = key
        return self._bank

    def expert_bank(self, x: torch.Tensor) -> torch.Tensor:
        """(E, B, out) in the module's dtype: one ``kan_forward`` per KAN layer
        over the stacked experts; each layer's output is cast to the module's
        dtype, as each JAX KANLinear's is."""
        h = x
        order = self.experts[0].layers[0].spline_order
        for grid, base_w, spline_w in self.stacked_layers():
            h = _ks.kan_forward(h.float().contiguous(), grid, base_w, spline_w, order).to(self.out_dtype)
        return h

    def forward(self, x: torch.Tensor, train: bool = False):
        gates, load = noisy_top_k_gating(x, self.w_gate, self.w_noise, self.k, train=train)
        balance = (cv_squared(gates.sum(dim=0)) + cv_squared(load)) * self.loss_coef
        y = torch.einsum("be,ebo->bo", gates, self.expert_bank(x).float())
        return y, balance
