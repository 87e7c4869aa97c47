"""BERT text encoder with HF state_dict names.

Counterpart of ``mdhs_tpu/models/bert.py``. Returns the last hidden state
and all hidden states. When the model is in eval mode and the activations are
bf16 on CUDA, each layer runs hand-written CUDA kernels where their
``supports()`` gates accept the shape (``_kernel_plan`` decides):

- under ``quantize="int8"`` (the int8 serving preset, eval only), the two
  sublayers as ``ops/quant_kernel.py``'s a8w8 kernels, whatever
  ``attention_impl`` is: the JAX int8 branch (``mdhs_tpu/models/bert.py:
  242-301``) reads no impl; where they reject the shape, the composite;
- otherwise under "auto" or "fused": the attention sublayer as
  ``ops/attention_block.py``; where that rejects the sequence length (L > 320
  at head_dim 64, seq 512 among them), the attention core as
  ``ops/fused_attention.py`` between cuBLAS projections; the FFN sublayer as
  ``ops/ffn_block.py``.

Under ``attention_impl="flash"`` the attention core is
``ops/flash_attention.py`` (the kernels on CUDA, bf16 only, in eval and,
with its backward kernels, in training) wherever the JAX gate
(``mdhs_tpu/models/bert.py:180-184``) takes the layer: eval or
``attention_dropout == 0``, and ``L % 128 == 0``. It masks by segment ids
(the attention mask), not by the -1e9 bias, so pad queries attend to pad
keys only (``docs/PARITY.md:19``); the FFN stays on the module path.

Elsewhere the layer takes the plain module path (f32 softmax, erf-GELU, as
the JAX "xla" path), or under int8 the ``ops/quant.py`` composite, as the JAX
package does off the TPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops import attention_block as _ab
from ..ops import ffn_block as _fb
from ..ops import flash_attention as _fl
from ..ops import fused_attention as _fa
from ..ops import quant_kernel as _qk
from ..ops.gelu import gelu
from ..ops.quant import int8_linear, quantize_weight

_IMPLS = ("auto", "fused", "xla", "flash")
_QUANTIZE = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Same fields and defaults as ``mdhs_tpu.models.bert.BertConfig``.

    ``attention_impl``: "auto" (kernels where eligible), "xla" (the JAX
    name of the module path), "fused" (the kernels, and an error where a
    CUDA bf16 eval call has a shape they do not support), or "flash" (the
    flash-attention kernels where the JAX flash gate takes the layer, and an
    error where a CUDA call's dtype or shape is not theirs; the module path
    elsewhere). ``quantize``: "none" (exact path) or "int8" (a8w8 serving
    preset, eval only; it reads no ``attention_impl``, as in JAX).
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    fast_math: bool = False
    attention_impl: str = "auto"
    quantize: str = "none"
    sp_mesh_shape: tuple = ()
    remat: str = "none"

    @classmethod
    def tiny(cls) -> "BertConfig":
        """Small config for tests."""
        return cls(
            vocab_size=512,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
        )

    def check_ported(self) -> None:
        """Raise for options the port does not have yet, naming the
        ROADMAP item that ports each; never ignore one silently."""
        if self.quantize not in _QUANTIZE:
            raise ValueError(f"quantize={self.quantize!r}: expected one of {_QUANTIZE}")
        if self.attention_impl not in _IMPLS:
            raise ValueError(f"attention_impl={self.attention_impl!r}: expected one of {_IMPLS}")
        if self.sp_mesh_shape:
            raise NotImplementedError("sp_mesh_shape (sequence parallelism) is ROADMAP Queue 1 item 12")
        if self.remat != "none":
            raise NotImplementedError(f"remat={self.remat!r} is a training knob: ROADMAP Queue 1 item 8")


_INT8_COMPOSITE = False


@contextlib.contextmanager
def int8_composite():
    """Inside this block int8 layers run the ``int8_dense`` composite, not the
    int8 kernels, on any device: how the port's card-side comparisons ask for
    the composite on the same model. An explicit request, not a fallback, and
    not a ``BertConfig`` value (the JAX config has no such knob)."""
    global _INT8_COMPOSITE
    before, _INT8_COMPOSITE = _INT8_COMPOSITE, True
    try:
        yield
    finally:
        _INT8_COMPOSITE = before


def _kernel_plan(cfg: BertConfig, training: bool, dtype: torch.dtype, is_cuda: bool, B: int,
                 L: int) -> tuple[bool, bool, bool]:
    """Which kernels a BertLayer forward takes: (the attention sublayer, the
    attention core alone, the FFN sublayer). Kernels run in eval only, on
    bf16 CUDA activations. Under ``quantize="int8"`` the int8 kernels, under
    every ``attention_impl``, wherever ``_qk.attn_supports`` / ``_qk.supports``
    take the shape (the composite elsewhere, and inside ``int8_composite()``);
    otherwise the bf16 kernels under "auto" and "fused", where "fused" raises
    if they do not take the shape."""
    if training or not is_cuda or dtype != torch.bfloat16:
        return False, False, False
    H, heads = cfg.hidden_size, cfg.num_attention_heads
    if cfg.quantize == "int8":
        if _INT8_COMPOSITE:
            return False, False, False
        return _qk.attn_supports(dtype, L, H, heads), False, _qk.supports(dtype, B * L, H, cfg.intermediate_size)
    if cfg.attention_impl not in ("auto", "fused"):
        return False, False, False
    use_attn = _ab.supports(dtype, L, H, heads)
    use_core = not use_attn and _fa.supports(dtype, L, H, heads)
    use_ffn = _fb.supports(dtype, B * L, H, cfg.intermediate_size)
    if cfg.attention_impl == "fused" and not ((use_attn or use_core) and use_ffn):
        raise ValueError(
            f"attention_impl='fused' but the kernels do not support dtype={dtype}, L={L}, hidden={H}, "
            f"heads={heads}, intermediate={cfg.intermediate_size}"
        )
    return use_attn, use_core, use_ffn


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **f)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, **f)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size, **f)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **f)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        h = self.word_embeddings(input_ids) + self.position_embeddings(pos)[None]
        h = h + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.LayerNorm(h))


class BertSelfAttention(nn.Module):
    """Multi-head attention core: returns ctx (B, L, H). With ``fused`` the
    core after the projections is ``ops/fused_attention.py``; where
    ``use_flash`` takes the layer, ``ops/flash_attention.py`` with the
    attention mask as segment ids."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        H = cfg.hidden_size
        self.cfg = cfg
        self.query = nn.Linear(H, H, **f)
        self.key = nn.Linear(H, H, **f)
        self.value = nn.Linear(H, H, **f)
        self.dropout = nn.Dropout(cfg.attention_dropout)
        # sqrt(head_dim) for fast_math, made once: a tensor made from a Python number
        # inside forward is a synchronous host-to-device copy on the card
        head_dim = H // cfg.num_attention_heads
        self.register_buffer("head_scale", torch.tensor(head_dim**0.5, **f), persistent=False)

    def use_flash(self, seq_len: int) -> bool:
        """The JAX flash gate (``mdhs_tpu/models/bert.py:180-184``)."""
        c = self.cfg
        return (c.attention_impl == "flash" and (not self.training or c.attention_dropout == 0.0)
                and seq_len % 128 == 0)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor, fused: bool = False,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        B, L, H = hidden.shape
        D = H // c.num_attention_heads
        if fused:
            return _fa.fused_attention(self.query(hidden), self.key(hidden), self.value(hidden),
                                       attn_bias.reshape(B, L), c.num_attention_heads, float(D) ** -0.5)
        if self.use_flash(L):
            if attention_mask is None:  # one segment: no mask, as JAX's segment_ids=None
                attention_mask = torch.ones((B, L), dtype=torch.int32, device=hidden.device)
            return _fl.flash_attention(self.query(hidden), self.key(hidden), self.value(hidden),
                                       attention_mask, c.num_attention_heads, float(D) ** -0.5)

        def split(t):
            return t.reshape(B, L, c.num_attention_heads, D).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        scores = q @ k.transpose(-1, -2)
        if c.fast_math:
            # bf16 softmax, as the JAX fast_math path
            scores = scores / self.head_scale.to(scores.dtype)
            probs = torch.softmax(scores + attn_bias.to(scores.dtype), dim=-1)
        else:
            scores = scores.float() / float(D) ** 0.5 + attn_bias
            probs = torch.softmax(scores, dim=-1).to(hidden.dtype)
        ctx = self.dropout(probs) @ v
        return ctx.transpose(1, 2).reshape(B, L, H)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, **f)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **f)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, ctx: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dropout(self.dense(ctx)))


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.self = BertSelfAttention(cfg, device=device, dtype=dtype)
        self.output = BertSelfOutput(cfg, device=device, dtype=dtype)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, device=device, dtype=dtype)


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **f)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **f)
        self.dropout = nn.Dropout(cfg.hidden_dropout)


class _Int8Weights(NamedTuple):
    """One BertLayer's six matrices quantized per output channel (int8 with
    float32 scales), and its biases and LayerNorm parameters in float32."""

    wqkv: torch.Tensor
    sqkv: torch.Tensor
    bqkv: torch.Tensor
    wo: torch.Tensor
    so: torch.Tensor
    bo: torch.Tensor
    g1: torch.Tensor
    be1: torch.Tensor
    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    g2: torch.Tensor
    be2: torch.Tensor


def _drop_int8_weights(layer: "BertLayer", incompatible_keys) -> None:
    """load_state_dict post-hook: the parameters may be new objects (assign=True)."""
    layer._int8 = None


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.attention = BertAttention(cfg, device=device, dtype=dtype)
        self.intermediate = BertIntermediate(cfg, device=device, dtype=dtype)
        self.output = BertOutput(cfg, device=device, dtype=dtype)
        # int8 weights, made once from the parameters and kept beside them on
        # their device. Plain attributes, not buffers: state_dict keeps the
        # converter's keys, and module.to(dtype) does not cast the scales.
        self._int8: Optional[_Int8Weights] = None
        self._int8_from: tuple = ()  # (parameter, is an inference tensor) it was made from
        self._int8_key: tuple = ()
        self.register_load_state_dict_post_hook(_drop_int8_weights)

    def _int8_version(self) -> tuple:
        # an inference tensor has no version counter (nor an in-place update outside inference mode)
        return tuple((p.data_ptr(), 0 if inf else p._version) for p, inf in self._int8_from)

    def int8_weights(self) -> _Int8Weights:
        """The quantized weights, made again whenever a parameter has changed
        since they were made: load_state_dict drops them, and a move or an
        in-place update changes a parameter's storage or version counter.

        While ``torch.export`` traces, the kept weights are returned as they
        are (the trace's parameters have no storage to compare): the exported
        program holds them as constants, made by an eager forward before the
        trace, and no request quantizes."""
        if torch.compiler.is_exporting():
            if self._int8 is None:
                raise RuntimeError("BertLayer.int8_weights: no int8 weights kept to export; run one eager "
                                   "forward before torch.export")
            return self._int8
        if self._int8 is None or self._int8_version() != self._int8_key:
            a, s, o = self.attention, self.attention.self, self.output
            with torch.inference_mode(False), torch.no_grad():
                wqkv, sqkv = quantize_weight(torch.cat([s.query.weight, s.key.weight, s.value.weight]))
                wo, so = quantize_weight(a.output.dense.weight)
                w1, s1 = quantize_weight(self.intermediate.dense.weight)
                w2, s2 = quantize_weight(o.dense.weight)
                f32 = lambda t: t.detach().float().contiguous()  # noqa: E731
                self._int8 = _Int8Weights(
                    wqkv, sqkv, f32(torch.cat([s.query.bias, s.key.bias, s.value.bias])),
                    wo, so, f32(a.output.dense.bias),
                    f32(a.output.LayerNorm.weight), f32(a.output.LayerNorm.bias),
                    w1, s1, f32(self.intermediate.dense.bias), w2, s2, f32(o.dense.bias),
                    f32(o.LayerNorm.weight), f32(o.LayerNorm.bias),
                )
            self._int8_from = tuple((p, p.is_inference()) for p in self.parameters())
            self._int8_key = self._int8_version()
        return self._int8

    def attention_sublayer(self, hidden, attn_bias, kernel: bool, fused_core: bool = False,
                           attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """LN(hidden + attention(hidden)); attn_bias is (B, 1, 1, L) float32.
        ``kernel``: the whole sublayer as one kernel; else ``fused_core``: the
        attention core as one kernel between the module's projections; else
        the module path, whose core is the flash one where its gate takes it."""
        a = self.attention
        if not kernel:
            return a.output(a.self(hidden, attn_bias, fused_core, attention_mask), hidden)
        c = self.cfg
        s = a.self
        wqkv = torch.cat([s.query.weight, s.key.weight, s.value.weight], dim=0)
        bqkv = torch.cat([s.query.bias, s.key.bias, s.value.bias], dim=0)
        head_dim = c.hidden_size // c.num_attention_heads
        return _ab.attention_block(
            hidden.contiguous(), wqkv, bqkv, a.output.dense.weight, a.output.dense.bias,
            a.output.LayerNorm.weight, a.output.LayerNorm.bias,
            attn_bias.reshape(hidden.shape[0], hidden.shape[1]),
            c.num_attention_heads, float(head_dim) ** -0.5, c.layer_norm_eps,
        )

    def ffn_sublayer(self, hidden, kernel: bool) -> torch.Tensor:
        """LN(hidden + W2 gelu(W1 hidden))."""
        c = self.cfg
        act = "tanh" if c.fast_math else "erf"
        o = self.output
        if not kernel:
            inter = gelu(self.intermediate.dense(hidden), act)
            return o.LayerNorm(hidden + o.dropout(o.dense(inter)))
        B, L, H = hidden.shape
        out = _fb.ffn_block(
            hidden.reshape(B * L, H), self.intermediate.dense.weight, self.intermediate.dense.bias,
            o.dense.weight, o.dense.bias, o.LayerNorm.weight, o.LayerNorm.bias,
            c.layer_norm_eps, act,
        )
        return out.reshape(B, L, H)

    def int8_attention_sublayer(self, hidden, attn_bias, w: _Int8Weights, kernel: bool) -> torch.Tensor:
        """a8w8 LN(hidden + attention(hidden)): the int8 kernel, or the
        ``int8_dense`` composite of ``mdhs_tpu/models/bert.py:274-287`` (f32
        softmax also under fast_math)."""
        c = self.cfg
        B, L, H = hidden.shape
        heads = c.num_attention_heads
        D = H // heads
        if kernel:
            return _qk.int8_attention_block(
                hidden.contiguous(), w.wqkv, w.sqkv, w.bqkv, w.wo, w.so, w.bo, w.g1, w.be1,
                attn_bias.reshape(B, L), heads, float(D) ** -0.5, c.layer_norm_eps,
            )
        dt = hidden.dtype
        qkv = int8_linear(hidden, w.wqkv, w.sqkv, w.bqkv, dt)
        q, k, v = (t.reshape(B, L, heads, D).transpose(1, 2) for t in qkv.split(H, dim=-1))
        scores = (q @ k.transpose(-1, -2)).float() / float(D) ** 0.5 + attn_bias
        probs = torch.softmax(scores, dim=-1).to(dt)
        ctx = (probs @ v).transpose(1, 2).reshape(B, L, H)
        return self.attention.output.LayerNorm(hidden + int8_linear(ctx, w.wo, w.so, w.bo, dt))

    def int8_ffn_sublayer(self, hidden, w: _Int8Weights, kernel: bool) -> torch.Tensor:
        """a8w8 LN(hidden + W2 gelu(W1 hidden)): the int8 kernel, or the
        composite of ``mdhs_tpu/models/bert.py:298-301``."""
        c = self.cfg
        act = "tanh" if c.fast_math else "erf"
        B, L, H = hidden.shape
        if kernel:
            out = _qk.int8_ffn_block(hidden.reshape(B * L, H), w.w1, w.s1, w.b1, w.w2, w.s2, w.b2,
                                     w.g2, w.be2, c.layer_norm_eps, act)
            return out.reshape(B, L, H)
        dt = hidden.dtype
        inter = gelu(int8_linear(hidden, w.w1, w.s1, w.b1, dt), act)
        return self.output.LayerNorm(hidden + int8_linear(inter, w.w2, w.s2, w.b2, dt))

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        int8 = c.quantize == "int8" and not self.training  # the knob is ignored in training
        B, L, _ = hidden.shape
        use_attn, use_core, use_ffn = _kernel_plan(c, self.training, hidden.dtype, hidden.is_cuda, B, L)
        if int8:
            w = self.int8_weights()
            hidden = self.int8_attention_sublayer(hidden, attn_bias, w, use_attn)
            return self.int8_ffn_sublayer(hidden, w, use_ffn)
        hidden = self.attention_sublayer(hidden, attn_bias, use_attn, use_core, attention_mask)
        return self.ffn_sublayer(hidden, use_ffn)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(cfg, device=device, dtype=dtype) for _ in range(cfg.num_hidden_layers)
        )


class BertModel(nn.Module):
    """BERT encoder. ``forward`` returns (last_hidden_state, all_hidden_states)."""

    def __init__(self, cfg: BertConfig = BertConfig(), device=None, dtype=None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device=device, dtype=dtype)
        self.encoder = BertEncoder(cfg, device=device, dtype=dtype)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ):
        B, L = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, L), dtype=torch.int32, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros((B, L), dtype=torch.int64, device=input_ids.device)
        hidden = self.embeddings(input_ids, token_type_ids)
        # HF-style additive mask in float32: 0 to attend, -1e9 at padding
        attn_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        all_hidden = [hidden]
        for layer in self.encoder.layer:
            hidden = layer(hidden, attn_bias, attention_mask)
            all_hidden.append(hidden)
        return hidden, tuple(all_hidden)
