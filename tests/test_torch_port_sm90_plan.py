"""The launch plan of the bf16 sublayers' products (``ops/bf16_gemm.py::plan``),
which the wrappers compute and the CUDA launchers run as given: tile width,
split count and cluster size, on the CPU, for a card of 132 SMs (the H100's).

The plan's rules: the LayerNorm GEMM runs unsplit as clusters of H / 128
blocks; the tile GEMM takes 256-column tiles where those fill the card, else
128; and where the blocks fill fewer than half the SMs, K is split into the
fewest parts that fill half, at 128 columns, unclustered."""

from __future__ import annotations

import pytest
import torch

from mdhs_tpu_torch.ops import attention_block as ab
from mdhs_tpu_torch.ops import bf16_gemm as bg
from mdhs_tpu_torch.ops import ffn_block as fb

SMS = 132
ROWS = (1, 37, 128, 4096, 65_536)
HIDDEN = (128, 256, 384, 512, 640, 768, 896, 1024)
DEPTH = (384, 768, 1536, 3072)


def _row_tiles(rows):
    return -(-rows // 128)


@pytest.mark.parametrize("depth", DEPTH)
@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("rows", ROWS)
def test_layer_norm_gemm_plan(rows, hidden, depth):
    p = bg.plan(rows, hidden, depth, True, SMS)
    tiles = _row_tiles(rows) * hidden // 128
    assert p.width == 128
    if p.splits == 1:
        assert p.cluster == hidden // 128 <= 8 and p.blocks == tiles
        assert 2 * tiles >= SMS or depth // 64 == 1
    else:
        assert p.cluster == 1 and 2 <= p.splits <= depth // 64 and p.blocks == tiles * p.splits
        assert 2 * tiles < SMS  # split only where the clusters leave most SMs idle
        # the fewest parts that fill half the card, or every k-step when even that cannot
        assert 2 * p.blocks >= SMS or p.splits == depth // 64
        assert 2 * tiles * (p.splits - 1) < SMS
        assert p.workspace(rows, hidden) == p.splits * rows * hidden


@pytest.mark.parametrize("depth", DEPTH)
@pytest.mark.parametrize("cols", [128, 384, 768, 2304, 3072])
@pytest.mark.parametrize("rows", ROWS)
def test_tile_gemm_plan(rows, cols, depth):
    p = bg.plan(rows, cols, depth, False, SMS)
    assert p.cluster == 1 and p.workspace(rows, cols) == (0 if p.splits == 1 else p.splits * rows * cols)
    wide = cols % 256 == 0 and _row_tiles(rows) * cols // 256 >= SMS
    if p.splits == 1:
        assert p.width == (256 if wide else 128) and p.blocks == _row_tiles(rows) * cols // p.width
    else:
        narrow = _row_tiles(rows) * cols // 128
        assert p.width == 128 and 2 * narrow < SMS and p.blocks == narrow * p.splits
        assert 2 * p.blocks >= SMS or p.splits == depth // 64


@pytest.mark.parametrize("rows, qkv, out, gemm1, gemm2", [
    # batch 1 at seq 128 (and a ragged and a one-row request: the same single row tile)
    (128, (128, 4, 1), (128, 11, 1), (128, 3, 1), (128, 11, 1)),
    (37, (128, 4, 1), (128, 11, 1), (128, 3, 1), (128, 11, 1)),
    (1, (128, 4, 1), (128, 11, 1), (128, 3, 1), (128, 11, 1)),
    # batch 8: 48 LayerNorm blocks, split in two
    (1024, (128, 1, 1), (128, 2, 1), (128, 1, 1), (128, 2, 1)),
    # batch 32 at seq 128, and the preset's batch 512: wide tiles, clusters of 6
    (4096, (256, 1, 1), (128, 1, 6), (256, 1, 1), (128, 1, 6)),
    (65_536, (256, 1, 1), (128, 1, 6), (256, 1, 1), (128, 1, 6)),
])
def test_bert_base_sublayer_plans(rows, qkv, out, gemm1, gemm2):
    a_qkv, a_out = ab.plans(rows, 768, SMS)
    f_1, f_2 = fb.plans(rows, 768, 3072, SMS)
    assert (a_qkv.args(), a_out.args(), f_1.args(), f_2.args()) == (qkv, out, gemm1, gemm2)


def test_every_plan_fills_half_the_card_at_batch_1():
    plans = (*ab.plans(128, 768, SMS), *fb.plans(128, 768, 3072, SMS))
    assert [p.blocks for p in plans] == [72, 66, 72, 66]
    assert all(2 * p.blocks >= SMS for p in plans)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("hidden", HIDDEN)
def test_clusters_stay_portable(rows, hidden):
    for p in (*ab.plans(rows, hidden, SMS), *fb.plans(rows, hidden, 4 * hidden, SMS)):
        assert 1 <= p.cluster <= 8


def test_plan_rejects_shapes_no_kernel_takes():
    for args in ((0, 768, 768, False), (128, 700, 768, False), (128, 768, 100, False), (128, 1152, 768, True)):
        with pytest.raises(ValueError):
            bg.plan(*args, SMS)


def test_products_alone_take_their_plain_versions_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    a = torch.randn((5, 128), generator=g).to(torch.bfloat16)
    w = (torch.randn((256, 128), generator=g) * 0.05).to(torch.bfloat16)
    b = (torch.randn((256,), generator=g) * 0.01).to(torch.bfloat16)
    assert torch.equal(bg.tile_gemm(a, w, b, "tanh"), bg.tile_gemm_reference(a, w, b, "tanh"))
    y = bg.ln_gemm(a, w[:128].contiguous(), b[:128], a, b[:128] + 1, b[:128], 1e-12)
    assert y.dtype == torch.bfloat16 and y.shape == (5, 128)
    with pytest.raises(ValueError, match="act="):
        bg.tile_gemm(a, w, b, "relu")
