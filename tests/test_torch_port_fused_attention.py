"""The port's fused_attention against the JAX package's, on the CPU.

The JAX kernel has no interpret mode, so the JAX side is its
``attention_reference``; the port's wrapper takes its plain version because
the tensors lie on the CPU. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdhs_tpu.ops import fused_attention as jfa
from mdhs_tpu_torch.models import bert as tbert
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.ops import attention_block as tab
from mdhs_tpu_torch.ops import fused_attention as tfa

torch.set_num_threads(2)


@pytest.mark.parametrize("entry", ["reference", "wrapper"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 384, 512])
def test_fused_attention_matches_jax_reference(L, dtype, entry):
    """float32: the same function, 1e-5. bf16: the JAX reference rounds the
    scores to bf16 before its float32 softmax, the port (as the TPU kernel)
    keeps them float32, so they agree to the JAX kernels' own bf16 bound
    (tests/test_fused_attention.py:126-127): max |d| <= 6e-2, mean < 5e-3."""
    B, HD, heads = 2, 64, 4
    rng = np.random.default_rng(L)
    q, k, v = (rng.standard_normal((B, L, HD)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), np.float32)
    mask[0, L - 5:] = 0.0
    mask[1, L // 3:] = 0.0
    bias = ((1.0 - mask) * -1e9).astype(np.float32)
    scale = float(HD // heads) ** -0.5
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    ref = np.asarray(jfa.attention_reference(jq, jk, jv, jnp.asarray(bias), heads, scale).astype(jnp.float32))

    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in (jq, jk, jv))
    fn = tfa.attention_reference if entry == "reference" else tfa.fused_attention
    launches = tfa.fused_attention.launches
    out = fn(tq, tk, tv, torch.from_numpy(bias), heads, scale)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, L, HD)
    assert tfa.fused_attention.launches == launches  # a CPU tensor takes the plain version
    d = np.abs(out.float().numpy() - ref)
    if dtype == "float32":
        assert d.max() < 1e-5, d.max()
    else:
        assert d.max() <= 6e-2 and d.mean() < 5e-3, (d.max(), d.mean())


@pytest.mark.parametrize("args, ok", [
    ((torch.bfloat16, 512, 768, 12), True),   # configs/connext/connext_ham.yml's seq 512
    ((torch.bfloat16, 384, 768, 12), True),
    ((torch.bfloat16, 500, 768, 12), True),   # ragged L: no L % 128 condition
    ((torch.bfloat16, 1, 768, 12), True),
    ((torch.bfloat16, 513, 768, 12), False),  # past max_position_embeddings
    ((torch.bfloat16, 512, 1024, 16), True),  # BERT-large widths
    ((torch.bfloat16, 512, 1024, 4), False),  # head_dim 256: more accumulators than a warp holds
    ((torch.bfloat16, 512, 384, 32), False),  # head_dim 12 is not a multiple of 8
    ((torch.bfloat16, 512, 768, 10), False),  # 768 % 10 != 0
    ((torch.float32, 512, 768, 12), False),
])
def test_fused_attention_supports(args, ok):
    assert tfa.supports(*args) is ok


@pytest.mark.parametrize("L", [336, 512])
def test_bert_takes_fused_attention_where_the_block_rejects(L):
    """The seq lengths BertLayer sends to fused_attention on the card."""
    assert not tab.supports(torch.bfloat16, L, 768, 12)
    assert tfa.supports(torch.bfloat16, L, 768, 12)


def test_bert_fused_core_plumbing_matches_module_path():
    """The arguments BertSelfAttention hands fused_attention (the projections
    in the (B, L, H*D) layout, the (B, L) bias, the scale) are right: on CPU
    tensors the wrapper takes its plain version, which must agree with the
    module path in float32."""
    cfg = tbert.BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=128, max_position_embeddings=64)
    gen = torch.Generator().manual_seed(3)
    model = init_parameters(tbert.BertModel(cfg), gen).eval()
    ids = torch.randint(0, 128, (3, 40), generator=gen)
    mask = torch.ones((3, 40), dtype=torch.int64)
    mask[1, 29:] = 0
    with torch.no_grad():
        _, hidden = model(ids, mask)
        bias = (1.0 - mask[:, None, None, :].float()) * -1e9
        for layer, h in zip(model.encoder.layer, hidden[:-1]):
            a_mod = layer.attention_sublayer(h, bias, kernel=False)
            a_core = layer.attention_sublayer(h, bias, kernel=False, fused_core=True)
            np.testing.assert_allclose(a_core.numpy(), a_mod.numpy(), atol=1e-5, rtol=0)


def test_fused_attention_raises_on_other_devices():
    q = torch.empty((1, 16, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.fused_attention(q, q, q, torch.empty((1, 16), device="meta"), 2, 0.125)


@pytest.mark.parametrize("head_dim", range(8, 129, 8))
def test_fused_attention_shared_memory_plan(head_dim):
    """The Python mirror of csrc/attention_sm90.cuh::plan: 128 queries a work
    item, 128-key tiles, 64-column chunks, a ring of 3 stages up to head_dim
    64 and 2 above (the header comment's figures), within the card's 232,448
    bytes."""
    assert (tfa._QT, tfa._KT, tfa._CHUNK) == (128, 128, 64)
    nc = 1 if head_dim <= 64 else 2
    assert (tfa._chunks(head_dim), tfa._stages(head_dim)) == (nc, 3 if nc == 1 else 2)
    assert tfa._smem_bytes(head_dim) == (133_712 if nc == 1 else 198_720) <= 232_448
    assert tfa.supports(torch.bfloat16, 512, 4 * head_dim, 4)
