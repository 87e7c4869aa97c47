"""Sparsely gated Mixture-of-Experts with KAN experts.

Counterpart of ``mdhs_tpu/modules/moe.py``: top-k gating on the softmaxed
logits with the renormalised top-k probabilities (in training on logits with
softplus-scaled Gaussian noise, and the load estimated from the normal CDF),
the cv^2 balance loss, and
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
gating is float32. In training the gating noise is drawn from an explicit
``torch.Generator`` on the module's device (or given, as ``noise``, by a
test): JAX's ``gating`` stream gives other numbers from a seed, the same
distribution. The expert bank's gradient reaches every expert's parameters
through ``kan_forward``'s autograd (``ops/_library.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kan_spline as _ks
from .kan import KAN


def cv_squared(x: torch.Tensor) -> torch.Tensor:
    """Squared coefficient of variation, var (ddof 1) / (mean^2 + 1e-10)."""
    x = x.float()
    if x.shape[0] == 1:
        return x.new_zeros(())
    return x.var(correction=1) / (x.mean() ** 2 + 1e-10)


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def noisy_top_k_gating(x, w_gate, w_noise, k: int, *, train: bool = False,
                       generator: Optional[torch.Generator] = None, noise_epsilon: float = 1e-2,
                       load_mode: str = "consistent", noise: Optional[torch.Tensor] = None):
    """(gates (B, E), load (E,)), ``mdhs_tpu/modules/moe.py::noisy_top_k_gating``.

    Eval (or training with neither ``generator`` nor ``noise``): clean logits,
    softmax, top-k, renormalised; load counts the rows that chose each expert.
    Training: logits plus N(0, 1) noise (from ``generator``, or ``noise``)
    times softplus(x @ w_noise) + noise_epsilon; the load is the differentiable
    P(expert in the top k) from the top-(k+1) thresholds, under ``load_mode``
    "consistent" (all in softmax space) or "reference" (the reference's mix of
    raw logits and softmaxed thresholds, moe.py:252-262)."""
    if load_mode not in ("consistent", "reference"):
        raise ValueError(f"unknown load_mode: {load_mode}")
    num_experts = w_gate.shape[1]
    clean_logits = x.float() @ w_gate.float()
    noisy = train and (generator is not None or noise is not None)
    noise_std = None
    logits = clean_logits
    if noisy:
        noise_std = F.softplus(x.float() @ w_noise.float()) + noise_epsilon
        if noise is None:
            noise = torch.randn(clean_logits.shape, generator=generator, device=clean_logits.device)
        logits = clean_logits + noise.float() * noise_std
    probs = torch.softmax(logits, dim=1)
    top_probs, top_idx = torch.sort(probs, dim=1, descending=True, stable=True)
    top_k_probs = top_probs[:, :k]
    top_k_gates = top_k_probs / (top_k_probs.sum(dim=1, keepdim=True) + 1e-6)
    gates = torch.zeros_like(probs).scatter(1, top_idx[:, :k], top_k_gates)
    if noisy and k < num_experts:
        threshold_if_in = top_probs[:, k:k + 1]
        threshold_if_out = top_probs[:, k - 1:k]
        if load_mode == "reference":
            is_in = logits > threshold_if_in
            prob_if_in = _normal_cdf((clean_logits - threshold_if_in) / noise_std)
            prob_if_out = _normal_cdf((clean_logits - threshold_if_out) / noise_std)
        else:
            clean_probs = torch.softmax(clean_logits, dim=1)
            is_in = probs > threshold_if_in
            prob_if_in = _normal_cdf((clean_probs - threshold_if_in) / (noise_std + 1e-9))
            prob_if_out = _normal_cdf((clean_probs - threshold_if_out) / (noise_std + 1e-9))
        load = torch.where(is_in, prob_if_in, prob_if_out).sum(dim=0)
    else:
        load = (gates > 0).float().sum(dim=0)
    return gates, load


class MoE(nn.Module):
    """``forward(x)`` returns (logits (B, output_size) float32, balance loss);
    ``forward(x, train=True, generator=g)`` gates with noise drawn from ``g``."""

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
        self.captured: list | None = None  # each bank layer's input, while a re-grid captures them

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
        dtype, as each JAX KANLinear's is. Where ``captured`` is a list, each
        layer's float32 input ((B, IN) shared by the experts at layer 0, then (E,
        B, IN)) is appended to it: what the JAX bank sows for the re-gridding."""
        h = x
        order = self.experts[0].layers[0].spline_order
        for grid, base_w, spline_w in self.stacked_layers():
            h = h.float().contiguous()
            if self.captured is not None:
                self.captured.append(h)
            h = _ks.kan_forward(h, grid, base_w, spline_w, order).to(self.out_dtype)
        return h

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """``train`` gates with noise (JAX's ``noisy_gating`` and ``load_mode``
        defaults, the only ones its configs build): from ``generator``, which
        training must give, or ``noise`` (B, E) where a test gives the values."""
        if train and generator is None and noise is None:
            raise ValueError("MoE.forward(train=True): the gating noise needs a generator (or noise)")
        gates, load = noisy_top_k_gating(x, self.w_gate, self.w_noise, self.k, train=train, generator=generator,
                                         noise=noise)
        balance = (cv_squared(gates.sum(dim=0)) + cv_squared(load)) * self.loss_coef
        y = torch.einsum("be,ebo->bo", gates, self.expert_bank(x).float())
        return y, balance
