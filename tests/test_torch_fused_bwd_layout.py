"""The host-side arithmetic of the bf16 fused SetTransformer backward
(kernel #4, ``csrc/fused_transformer_bf16.cu``), on the CPU: the padded
weight layouts its tensor-core products read (``padded_layouts``), and its
tile, shared memory and grid per compute dtype (``bwd_shape``,
``bwd_grid``).  Needs neither a card nor nvcc."""

import numpy as np
import pytest
import torch

from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

# (kd, n) of the weights at the flagship width (in 4, hidden 96, out 104)
# and at the card tests' hidden 24
SHAPES = [(4, 96), (96, 288), (96, 96), (96, 192), (192, 96), (96, 104),
          (4, 24), (24, 72), (24, 48), (48, 24), (24, 104)]


@pytest.mark.parametrize("kd,n", SHAPES)
def test_padded_layouts_are_zero_padded_casts(kd, n):
    rng = np.random.default_rng(kd * 1000 + n)
    wb = torch.tensor(rng.standard_normal((2, kd, n))).to(torch.bfloat16)
    other = torch.ones(3, 24, 40, dtype=torch.bfloat16)  # a second matrix
    fwd, _, bwd, _ = ft.padded_layouts([wb, other])
    pk, pn = ft.pad16(kd), ft.pad16(n)
    assert fwd.shape == (2, pn, pk) and bwd.shape == (2, pk, pn)
    assert fwd.dtype == bwd.dtype == torch.bfloat16
    assert fwd.is_contiguous() and bwd.is_contiguous()
    # 4-byte aligned for the kernel's paired loads
    assert fwd.data_ptr() % 4 == 0 and bwd.data_ptr() % 4 == 0
    assert torch.equal(fwd[:, :n, :kd], wb.transpose(1, 2))
    assert torch.equal(bwd[:, :kd, :n], wb)
    for t, rows, cols in ((fwd, n, kd), (bwd, kd, n)):
        assert not t[:, rows:].any() and not t[:, :, cols:].any()


@pytest.mark.parametrize("kd,n", SHAPES)
def test_products_through_padded_layouts_equal_unpadded(kd, n):
    """x @ W through W^T and g @ W^T through W, with x and g zero past
    their widths as the kernel keeps them in shared memory: the padded
    columns of the result are zero and the rest equals the unpadded
    product (in float64, where the bf16 products and their sums are
    exact)."""
    rng = np.random.default_rng(kd + 7 * n)
    w = torch.tensor(rng.standard_normal((kd, n))).to(torch.bfloat16)
    fwd, bwd = ft.padded_layouts([w])
    pk, pn = ft.pad16(kd), ft.pad16(n)
    wb = w.double()
    x = torch.tensor(rng.standard_normal((64, kd))).to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((64, n))).to(torch.bfloat16)
    pad = torch.nn.functional.pad
    y = pad(x, (0, pk - kd)).double() @ fwd.double().T
    dx = pad(g, (0, pn - n)).double() @ bwd.double().T
    assert y.shape == (64, pn) and dx.shape == (64, pk)
    torch.testing.assert_close(y[:, :n], x.double() @ wb, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(dx[:, :kd], g.double() @ wb.T, rtol=1e-12,
                               atol=1e-12)
    assert not y[:, n:].any() and not dx[:, kd:].any()


FLAGSHIP = dict(in_dim=4, hidden=96, mlp=192, out_dim=104, heads=4,
                layers=2)


def test_bwd_shape_of_the_flagship_per_dtype():
    bf16, f32 = torch.bfloat16, torch.float32
    tile, smem = ft.bwd_shape(bf16, 16, **FLAGSHIP)
    # 64 rows: (L + 6) [64, 104] buffers, qkv [64, 296], the MLP pair
    # [64, 2 x 200], all bf16, and the fp32 softmax statistics
    assert tile == 64
    assert smem == 2 * 64 * (8 * 104 + 296 + 400) + 4 * 64 * 3 * 4 == 198_656
    assert smem <= ft.MAX_SMEM and ft.smem_blocks_per_sm(smem) == 1
    assert ft.bwd_grid(16_384, tile, smem, 132) == 132
    assert ft.bwd_grid(112, tile, smem, 132) == 2
    # fp32 keeps its 32-row tile and fp32 rows one float wider
    tile, smem = ft.bwd_shape(f32, 16, **FLAGSHIP)
    assert tile == 32
    assert smem == 4 * 32 * (8 * 97 + 289 + 386 + 3 * 4) == 187_264
    assert ft.bwd_grid(4096, tile, smem, 132) == 128


@pytest.mark.parametrize("s,tile", [(32, 64), (16, 64), (6, 60), (24, 48),
                                    (17, 51), (1, 64)])
def test_bf16_tiles_hold_whole_sets_and_fit(s, tile):
    """Whole sets up to 64 rows, padded to 16-row m-tiles; S = 32 (two sets
    a tile) fits at the flagship width like S = 16."""
    got, smem = ft.bwd_shape(torch.bfloat16, s, **FLAGSHIP)
    assert got == tile and got % s == 0
    assert smem <= ft.MAX_SMEM
    if ft.pad16(tile) == 64:
        assert smem == ft.bwd_shape(torch.bfloat16, 16, **FLAGSHIP)[1]


def test_deeper_nets_take_32_row_tiles():
    """A net with 5 blocks does not fit a 64-row bf16 tile; the kernel then
    takes 32 rows, so every shape the fp32-layout kernel took still fits."""
    deep = dict(FLAGSHIP, layers=5)
    tile, smem = ft.bwd_shape(torch.bfloat16, 16, **deep)
    assert tile == 32 and smem <= ft.MAX_SMEM
    for layers, hidden in ((2, 112), (5, 96), (6, 64)):
        net = dict(FLAGSHIP, layers=layers, hidden=hidden, mlp=2 * hidden)
        if ft.bwd_shape(torch.float32, 16, **net)[1] <= ft.MAX_SMEM:
            assert ft.bwd_shape(torch.bfloat16, 16, **net)[1] <= ft.MAX_SMEM
