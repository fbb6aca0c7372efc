"""The host-side arithmetic of the bf16 fused SetTransformer forward (kernel
#3, ``csrc/fused_transformer_bf16.cu``), on the CPU: its tile, shared memory
and blocks an SM (``fwd_shape``, ``fwd_blocks_per_sm``), the calls it takes
(``supported``), and the weights it reads (``pack_matrices``: the padded
layouts it shares with the bf16 backward, cast straight from fp32 at pack
time).  Needs neither a card nor nvcc."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
# in 4, hidden 96, MLP 192 (ratio 2)
FLAGSHIP = dict(in_dim=4, hidden=96, mlp=192)
# the widest bf16 net: hidden 256, MLP ratio 8
WIDE = dict(in_dim=4, hidden=256, mlp=2048)


def test_fwd_shape_of_the_flagship():
    """64 rows (four sets of 16) in three bf16 buffers: h and the
    LN/attention output [64, 96 + 8], and qkv [64, 288 + 8], the widest of
    x, qkv and the MLP hidden layer: 63 KB, so shared memory holds three
    blocks of 8 warps an SM; the launch bounds give registers for two."""
    tile, smem = ft.fwd_shape(BF16, 16, **FLAGSHIP)[:2]
    assert tile == 64
    assert smem == 2 * 64 * (104 + 104 + 296) == 64_512
    assert ft.smem_blocks_per_sm(smem) == 3
    assert ft.fwd_blocks_per_sm(smem) == ft.FWD_BLOCKS == 2
    # the fp32 forward keeps its 32-row tile of fp32 rows
    assert ft.fwd_shape(F32, 16, **FLAGSHIP) == (
        32, ft.smem_bytes(16, 4, 96, 192), 1)


@pytest.mark.parametrize("s,tile,half", [(1, 64, 32), (6, 60, 30),
                                         (16, 64, 32), (17, 51, 17),
                                         (24, 48, 24), (32, 64, 32)])
def test_bf16_fwd_tiles_hold_whole_sets_and_fit(s, tile, half):
    """Whole sets up to 64 rows, one set where a set is larger, padded to
    at most four 16-row m-tiles; shared memory holds three blocks an SM at
    the flagship width.  A net too wide for 64 rows (hidden 256, MLP ratio
    8) takes whole sets up to 32 rows, one block an SM."""
    got, smem = ft.fwd_shape(BF16, s, **FLAGSHIP)[:2]
    assert got == tile and got % s == 0 and ft.pad16(got) <= 64
    assert smem == 2 * ft.pad16(got) * (104 + 104 + 296)
    assert ft.smem_blocks_per_sm(smem) >= 3
    assert ft.fwd_blocks_per_sm(smem) == ft.FWD_BLOCKS
    got, smem = ft.fwd_shape(BF16, s, **WIDE)[:2]
    assert got == half and got % s == 0 and ft.pad16(got) <= 32
    assert smem == 2 * ft.pad16(got) * (264 + 264 + 2056) <= ft.MAX_SMEM
    assert ft.fwd_blocks_per_sm(smem) == 1


def test_wide_nets_take_half_tiles():
    """An MLP too wide for a 64-row tile (ratio 8 at hidden 256) takes 32
    rows; the backward's limit on the width still holds it."""
    tile, smem = ft.fwd_shape(BF16, 16, **WIDE)[:2]
    assert tile == 32 and smem == 2 * 32 * (2 * 264 + 2056) <= ft.MAX_SMEM
    assert 2 * 64 * (2 * 264 + 2056) > ft.MAX_SMEM
    assert ft.supported(torch.zeros(2, 16, 4), None, None, 256, 4, 8,
                        compute_dtype=BF16)


@pytest.mark.parametrize("hidden,heads,ok", [(96, 4, True), (256, 4, True),
                                             (264, 4, False), (288, 3, False)])
def test_supported_rejects_hidden_over_256_in_bf16(hidden, heads, ok):
    """The kernels hold an LN row in registers, 8 values a lane: at most
    256 wide in bf16.  fp32's forward takes these widths."""
    x = torch.zeros(2, 16, 4)
    assert ft.supported(x, None, None, hidden, heads,
                        compute_dtype=BF16) == ok
    assert ft.supported(x, None, None, hidden, heads)


def test_supported_keeps_its_other_rules_in_bf16():
    """A key mask of the sets' shape is taken since the kernels take one;
    a mask of another shape is not; sets up to 128 rows are taken, 129 is
    not."""
    x = torch.zeros(2, 16, 4)
    assert ft.supported(x, None, torch.ones(2, 16), 96, 4,
                        compute_dtype=BF16)
    assert not ft.supported(x, None, torch.ones(2, 15), 96, 4,
                            compute_dtype=BF16)
    assert not ft.supported(x, None, None, 96, 5, compute_dtype=BF16)
    assert not ft.supported(torch.zeros(2, 129, 4), None, None, 96, 4,
                            compute_dtype=BF16)
    assert ft.supported(torch.zeros(2, 128, 4), None, None, 96, 4,
                        compute_dtype=BF16)
    assert ft.supported(torch.zeros(2, 33, 4), None, None, 96, 4,
                        compute_dtype=BF16)


def _ws(hidden=96, heads=4, seed=0):
    net = SetTransformer(4, 104, hidden_dim=hidden, num_heads=heads,
                         compute_dtype="bfloat16",
                         generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        rng = np.random.default_rng(seed)
        for p in net.parameters():
            p.copy_(torch.tensor(rng.standard_normal(p.shape)))
    return ft.flatten_params(net)


@pytest.mark.parametrize("hidden,heads", [(96, 4), (24, 4), (48, 2)])
def test_packed_bf16_layouts_equal_padded_layouts_of_the_cast_weights(
        hidden, heads):
    """The pack casts fp32 straight into the layouts; bitwise the layouts
    of the bf16-cast weights.  The forward reads the 6 W^T layouts, the
    backward all 12."""
    ws = _ws(hidden, heads)
    with torch.no_grad():
        fwd, bwd = ft.pack_matrices(ws, BF16)
        want = ft.padded_layouts([ws[j].detach().to(BF16)
                                  for j in (0, 2, 4, 6, 8, 10)])
    assert len(fwd) == 6 and len(bwd) == 12
    assert all(a is b for a, b in zip(fwd, bwd[:6]))
    for got, w in zip(bwd, want):
        assert got.dtype == BF16 and got.is_contiguous()
        assert torch.equal(got, w)


def test_packed_fp32_matrices_are_the_weights():
    """fp32: the backward reads the 6 matrices as they are, the 3xTF32
    forward their ``tf32x3_layouts`` (hi + lo gives each back to fp32's
    rounding)."""
    ws = _ws()
    with torch.no_grad():
        fwd, bwd = ft.pack_matrices(ws, F32)
        want = ft.tf32x3_layouts([ws[j].detach()
                                  for j in (0, 2, 4, 6, 8, 10)])
    assert len(fwd) == len(bwd) == 6
    for got, j in zip(bwd, (0, 2, 4, 6, 8, 10)):
        assert got.dtype == F32 and torch.equal(got, ws[j])
    for got, w, j in zip(fwd, want, (0, 2, 4, 6, 8, 10)):
        kd, n = ws[j].shape[-2:]
        assert got.dtype == F32 and got.is_contiguous()
        assert got.shape == (*ws[j].shape[:-2], ft.pad8(n), 2 * ft.pad8(kd))
        assert torch.equal(got, w)
        parts = got.unflatten(-1, (-1, 4, 2, 2))
        back = (parts[..., 0, :] + parts[..., 1, :]).transpose(-1, -2) \
            .flatten(-3)[..., :n, :kd]
        torch.testing.assert_close(back, ws[j].detach().transpose(-1, -2),
                                   rtol=2.0 ** -21, atol=0.0)


class _Ops(TorchDispatchMode):
    """Counts the operators that move data (not views)."""

    VIEWS = {"detach", "view", "alias", "slice", "transpose",
             "split_with_sizes"}

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in self.VIEWS:
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def test_bf16_repack_costs_one_fill_and_12_casting_copies():
    """A bf16 repack (after every optimizer step) makes both kernels'
    layouts in 13 operations: one zero fill and a copy a layout that also
    casts, against 19 for a cast of each matrix and then the layouts."""
    ws = _ws()
    with torch.no_grad(), _Ops() as new:
        ft.pack_matrices(ws, BF16)
    with torch.no_grad(), _Ops() as old:
        ft.padded_layouts([ws[j].detach().to(BF16)
                           for j in (0, 2, 4, 6, 8, 10)])
    assert sorted(new.ops) == ["copy_"] * 12 + ["zeros"]
    assert len(old.ops) == 19
