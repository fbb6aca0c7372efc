"""wgrad_tiles_bf16's plain version and the layout of its operand images, on
the CPU.

#4 bf16's global layout (the molecule nets of hidden 256) leaves each
tile's dense-layer operands as images and ``wgrad_tiles_bf16`` contracts
them over all tiles in the order of the backward's persistent grid.  Its
plain version, ``wgrad_tiles_plain``, is held here against a float64
X^T G over every row, with rows of zero cotangent shown to add nothing;
the workspace's size at runs/moses' shape and at the forced global layout
of hidden 96 and 192 is worked out by hand; the image order and the entry
point's arguments are read from the CUDA source.  The kernel itself runs on
the card (``tests/test_torch_cuda.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16

# hidden 32, MLP 64, in 3, out 10, two layers; sets of 6, tiles of 12 rows
# (two sets) padded to 16; 54 rows: 5 tiles, the last with 6 valid rows
SMALL = ft.WgradShape(rows=54, set_size=6, in_dim=3, hidden=32, layers=2,
                      mlp=64, out_dim=10)
TILE = 12


def _images(shape, tile, seed, pad_rows_zero=False):
    """Random bf16 operand images of every tile, zero past each operand's
    width (as the kernel's producers leave them); with ``pad_rows_zero``,
    every operand zero on the rows that hold no valid row (past a tile's
    sets and past the last row)."""
    rng = np.random.default_rng(seed)
    tp, tiles = ft.pad16(tile), -(-shape.rows // tile)
    true = {"x": shape.in_dim, "g": shape.out_dim, "a_out": shape.hidden,
            "g_embed": shape.hidden, "a1": shape.hidden, "o": shape.hidden,
            "a2": shape.hidden, "m": shape.mlp, "g_fc2": shape.hidden,
            "g_fc1": shape.mlp, "g_proj": shape.hidden,
            "g_qkv": 3 * shape.hidden}
    valid = np.minimum(tile, shape.rows - tile * np.arange(tiles))
    parts = []
    for name, w in ft.wgrad_images(shape):
        a = np.zeros((tiles, tp, w), np.float32)
        a[:, :, :true[name.split(":")[0]]] = rng.standard_normal(
            (tiles, tp, true[name.split(":")[0]]))
        if pad_rows_zero:
            a[np.arange(tp)[None, :] >= valid[:, None]] = 0.0
        parts.append(torch.from_numpy(a).to(BF16))
    return torch.cat([p.flatten(1) for p in parts], 1).flatten()


def _float64_sums(images, shape, tile):
    """dW = sum over every tile and row of X^T G and db = sum of G, in
    float64, flat in flatten_params order."""
    tp, tiles = ft.pad16(tile), -(-shape.rows // tile)
    widths = ft.wgrad_images(shape)
    per = images.double().view(tiles, -1)
    at, views = 0, {}
    for name, w in widths:
        views[name] = per[:, at:at + tp * w].view(tiles, tp, w)
        at += tp * w
    ws, bs = [], []
    for xi, gi, kd, n in ft.wgrad_products(shape):
        x, g = views[xi][:, :, :kd], views[gi][:, :, :n]
        ws.append(torch.einsum("trk,trn->kn", x, g).flatten())
        bs.append(g.sum((0, 1)))
    L = shape.layers
    flat = [ws[0], bs[0]]
    for j in range(4):
        flat += [torch.cat(ws[1 + j * L:1 + (j + 1) * L]),
                 torch.cat(bs[1 + j * L:1 + (j + 1) * L])]
    return torch.cat(flat + [ws[-1], bs[-1]])


@pytest.mark.parametrize("grid", [2, 3])
def test_plain_matches_float64_sums(grid):
    """Each of the 12 gradients (the matrices before their bf16 rounding)
    within 1e-6 of its largest float64 value; rounded, the matrices are
    the unrounded sums cast to bf16 and the biases unchanged."""
    images = _images(SMALL, TILE, grid)
    want = _float64_sums(images, SMALL, TILE)
    got = ft.wgrad_tiles_plain(images, SMALL, TILE, grid,
                               round_matrices=False)
    sizes = [int(np.prod(s)) for s in SMALL.weight_shapes()]
    assert got.dtype == torch.float32 and got.numel() == sum(sizes)
    for j, (a, b) in enumerate(zip(got.split(sizes), want.split(sizes))):
        assert float((a.double() - b).abs().max()) <= 1e-6 * float(
            b.abs().max()), j
    rounded = ft.wgrad_tiles_plain(images, SMALL, TILE, grid)
    for j, (a, b) in enumerate(zip(rounded.split(sizes), got.split(sizes))):
        assert torch.equal(a, b.to(BF16).float() if j % 2 == 0 else b), j


def test_wrapper_takes_the_plain_version_on_the_cpu():
    images = _images(SMALL, TILE, 5)
    assert torch.equal(ft.wgrad_tiles_bf16(images, SMALL, TILE, 3),
                       ft.wgrad_tiles_plain(images, SMALL, TILE, 3))
    with pytest.raises(ValueError):
        ft.wgrad_tiles_bf16(images[:-1], SMALL, TILE, 3)


def test_rows_with_zero_cotangents_add_nothing():
    """Rows past a tile's sets and past the last row carry zero cotangents:
    whatever the inputs X hold there, the gradients are the same."""
    zero = _images(SMALL, TILE, 7, pad_rows_zero=True)
    tp, tiles = ft.pad16(TILE), -(-SMALL.rows // TILE)
    valid = np.minimum(TILE, SMALL.rows - TILE * np.arange(tiles))
    pad = torch.from_numpy(np.arange(tp)[None, :] >= valid[:, None])
    junk = zero.clone().view(tiles, -1)
    at = 0
    for name, w in ft.wgrad_images(SMALL):
        if not name.startswith("g"):  # an input X: junk on the pad rows
            v = junk[:, at:at + tp * w].view(tiles, tp, w)
            v[pad] = torch.randn(int(pad.sum()), w).to(BF16)
        at += tp * w
    assert not torch.equal(junk.flatten(), zero)
    for grid in (2, 5):
        assert torch.equal(
            ft.wgrad_tiles_plain(junk.flatten(), SMALL, TILE, grid),
            ft.wgrad_tiles_plain(zero, SMALL, TILE, grid))


# (hidden, graphs, tile rows, tile_pad, out) -> bf16 elements of the images:
# ceil(rows / tile) tiles x tile_pad rows x the widths padded to 16 of x
# (in 6 -> 16), g (out), a_out and g_embed (H each), and per layer a1, o,
# a2, g_fc2, g_proj (H each), m and g_fc1 (MLP each), g_qkv (3H)
WORKSPACE = {
    # runs/moses: 4,608 rows in 192 tiles of 24 (padded to 32), out 300
    256: (192, 24, 32, 300,
          192 * 32 * (16 + 304 + 2 * 256 + 2 * (5 * 256 + 2 * 512 + 768))),
    # the forced global layout of the shared tiles: hidden 96 at 48 rows
    # (two sets; 3,072 rows in 64 tiles), hidden 192 at 24 (128 tiles)
    96: (128, 48, 48, 156,
         64 * 48 * (16 + 160 + 2 * 96 + 2 * (5 * 96 + 2 * 192 + 288))),
    192: (128, 24, 32, 156,
          128 * 32 * (16 + 160 + 2 * 192 + 2 * (5 * 192 + 2 * 384 + 576)))}


@pytest.mark.parametrize("hidden", sorted(WORKSPACE))
def test_workspace_elems(hidden):
    graphs, tile, tile_pad, out, elems = WORKSPACE[hidden]
    shape = ft.WgradShape(graphs * 24, 24, 6, hidden, 2, 2 * hidden, out)
    layout = ft.bwd_layout(BF16, 24, 6, hidden, 2 * hidden, out, 4, 2,
                           global_h=True)
    assert layout[0] == tile and layout[2]
    assert ft.pad16(tile) == tile_pad
    assert ft.wgrad_workspace_elems(shape, tile) == elems
    if hidden == 256:
        # 85.7 MB of images, against 569.5 MiB of the per-block slices
        assert elems * 2 == 85_721_088
        assert ft.bwd_layout(BF16, 24, 6, hidden, 2 * hidden, out, 4, 2)[2]


def _source():
    with open(os.path.join(REPO, "categoricalnf_tpu_torch", "csrc",
                           "fused_transformer_bf16.cu")) as f:
        return f.read()


def test_image_order_is_the_kernels():
    """``wgrad_images``' order is ``images_of``'s in the CUDA source."""
    body = re.search(r"Images images_of\(const Dims& dm\) \{(.*?)\n\}",
                     _source(), re.S).group(1)
    order = [n for n in re.findall(r"im\.(\w+) = ", body)
             if n not in ("layer", "tile")]
    names = []
    for name, _ in ft.wgrad_images(SMALL):
        if name.split(":")[0] not in names:
            names.append(name.split(":")[0])
    assert order == names


def test_entry_arguments_match_the_wrapper():
    """The C entry point ``wgrad_tiles_bf16`` against the ctypes list its
    wrapper calls it with."""
    m = re.search(r"\bint wgrad_tiles_bf16\((.*?)\)\s*\{", _source(), re.S)
    params = [p.strip().rsplit(" ", 1) for p in
              " ".join(m.group(1).split()).split(",")]
    kinds = {"const void*": ft._P, "float*": ft._P, "void*": ft._P,
             "long": ft._L, "int": ft._I}
    assert [kinds[t.replace(" *", "*")] if not n.startswith("*")
            else ft._P for t, n in params] == ft._WGRAD_ARGS
    assert [n.lstrip("*") for _, n in params] == [
        "images", "dw", "rows", "set_size", "in_dim", "hidden", "layers",
        "mlp", "out_dim", "tile", "grid", "stream"]

