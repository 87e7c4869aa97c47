"""BERT text encoder with HF state_dict names.

Counterpart of ``mdhs_tpu/models/bert.py``. Returns the last hidden state
and all hidden states. The attention and FFN sublayers of each layer run as
the hand-written CUDA kernels (``ops/attention_block.py``,
``ops/ffn_block.py``) when the model is in eval mode, the activations are
bf16 on CUDA, ``attention_impl`` is "auto" or "fused", and the kernel's
``supports()`` accepts the shape; otherwise the layer takes the plain module
path (f32 softmax, erf-GELU, as the JAX "xla" path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..ops import attention_block as _ab
from ..ops import ffn_block as _fb
from ..ops.gelu import gelu

_IMPLS = ("auto", "fused", "plain")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Same fields and defaults as ``mdhs_tpu.models.bert.BertConfig``.

    ``attention_impl``: "auto" (sublayer kernels where eligible), "plain"
    (the module path, the JAX package's "xla"), or "fused" (the kernels, and
    an error where a CUDA bf16 eval call has a shape they do not support).
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
        if self.quantize != "none":
            raise NotImplementedError(
                f"quantize={self.quantize!r}: the int8 serving preset is ROADMAP Queue 1 "
                "item 7 with Queue 2 items 4-5 (int8_ffn_block, int8_attention_block)"
            )
        if self.attention_impl == "flash":
            raise NotImplementedError(
                "attention_impl='flash' is ported with fused_attention, ROADMAP Queue 2 item 3"
            )
        if self.attention_impl not in _IMPLS:
            raise ValueError(f"attention_impl={self.attention_impl!r}: expected one of {_IMPLS}")
        if self.sp_mesh_shape:
            raise NotImplementedError("sp_mesh_shape (sequence parallelism) is ROADMAP Queue 1 item 12")
        if self.remat != "none":
            raise NotImplementedError(f"remat={self.remat!r} is a training knob: ROADMAP Queue 1 item 8")


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
    """Plain multi-head attention core: returns ctx (B, L, H)."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        H = cfg.hidden_size
        self.cfg = cfg
        self.query = nn.Linear(H, H, **f)
        self.key = nn.Linear(H, H, **f)
        self.value = nn.Linear(H, H, **f)
        self.dropout = nn.Dropout(cfg.attention_dropout)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, L, H = hidden.shape
        D = H // c.num_attention_heads

        def split(t):
            return t.reshape(B, L, c.num_attention_heads, D).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        scores = q @ k.transpose(-1, -2)
        if c.fast_math:
            # bf16 softmax, as the JAX fast_math path
            scores = scores / torch.tensor(D**0.5, dtype=scores.dtype, device=scores.device)
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


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.attention = BertAttention(cfg, device=device, dtype=dtype)
        self.intermediate = BertIntermediate(cfg, device=device, dtype=dtype)
        self.output = BertOutput(cfg, device=device, dtype=dtype)

    def _kernels_eligible(self, hidden: torch.Tensor) -> bool:
        return (
            self.cfg.attention_impl in ("auto", "fused")
            and not self.training
            and hidden.dtype == torch.bfloat16
            and hidden.is_cuda
        )

    def attention_sublayer(self, hidden, attn_bias, kernel: bool) -> torch.Tensor:
        """LN(hidden + attention(hidden)); attn_bias is (B, 1, 1, L) float32."""
        a = self.attention
        if not kernel:
            return a.output(a.self(hidden, attn_bias), hidden)
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

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        use_attn = use_ffn = False
        if self._kernels_eligible(hidden):
            B, L, H = hidden.shape
            use_attn = _ab.supports(hidden.dtype, L, H, c.num_attention_heads)
            use_ffn = _fb.supports(hidden.dtype, B * L, H, c.intermediate_size)
            if c.attention_impl == "fused" and not (use_attn and use_ffn):
                raise ValueError(
                    "attention_impl='fused' but the sublayer kernels do not support "
                    f"dtype={hidden.dtype}, L={L}, hidden={H}, heads={c.num_attention_heads}, "
                    f"intermediate={c.intermediate_size}"
                )
        hidden = self.attention_sublayer(hidden, attn_bias, use_attn)
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
            hidden = layer(hidden, attn_bias)
            all_hidden.append(hidden)
        return hidden, tuple(all_hidden)
