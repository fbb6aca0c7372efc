"""Wrappers of the fused SetTransformer kernels: the forward (#3) and its
backward (#4).  In fp32 the forward of a call without grad (the eval_model
twin) is the 3xTF32 tensor-core kernel of
``csrc/fused_transformer_tf32x3.cu``; a differentiable call's forward and
the backward are the FMA kernels of ``csrc/fused_transformer.cu`` (the
backward with regions of its tile in a global workspace:
``csrc/fused_transformer_f32_ws.cu``; sets of 33 to 128 rows:
``csrc/fused_transformer_f32_big.cu``, a set over a thread-block cluster),
one arithmetic.  In bf16 both are the tensor-core
kernels of ``csrc/fused_transformer_bf16.cu``.

Counterparts of ``_fused_fwd`` and ``_fused_bwd`` in
``categoricalnf_tpu/ops/pallas/fused_transformer.py``.  The kernels' plain
version is the unfused path of ``networks.transformer.SetTransformer``
(``plain_forward``, and autograd through it), which every CPU tensor takes;
these wrappers take CUDA tensors only and raise on what the kernels do not
take.  ``PackedWeights`` checks and casts the weights once, so a launch does
neither; in bf16 it casts them straight into the padded operand layouts
that both tensor-core kernels read (``padded_layouts``), in fp32 it splits
them into the TF32 pairs the forward reads (``tf32x3_layouts``) and into
the zero-padded W and W^T that the FMA pair reads (``padded_layouts`` with
``pad4``).  ``FusedSetTransformer`` ties the two kernels together for
autograd, as ``defvjp`` does in the reference.  ``LAUNCHES`` and
``BWD_LAUNCHES`` count launches by compute dtype, ``TRAIN_FWD_LAUNCHES``
those of the fp32 FMA forward of a differentiable call, each at sets up
to 32 (``csrc/fused_transformer.cu``'s instances), and
``CLUSTER_TRAIN_FWD_LAUNCHES`` and ``CLUSTER_BWD_LAUNCHES`` the fp32
pair's at sets above 32 (its instances over clusters);
``MASKED_LAUNCHES``, ``MASKED_TRAIN_FWD_LAUNCHES`` and
``MASKED_BWD_LAUNCHES`` count, among all of them, those that took a key
mask, and ``GLOBAL_H_BWD_LAUNCHES`` the backward's with regions in a
global workspace (nets whose tile does not fit otherwise: in bf16 the
residual copies at hidden 256; in fp32 also the MLP pair at 192, and qkv
at 256).  bf16's global layout leaves its dense layers' operands as images
(``wgrad_images``) and ``wgrad_tiles_bf16``, a kernel of its own, sums its
weight gradients from them (``GLOBAL_H_WGRAD_LAUNCHES``; plain version
``wgrad_tiles_plain``).

A key mask ``[B, S]`` (nonzero = a valid key) reaches every kernel as one
byte a key, cast once here: the logits of masked keys are -1e9 before the
softmax, as in the reference's masked attention.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from categoricalnf_tpu_torch.ops.cuda import build

# Must agree with csrc/fused_transformer_fma.cuh (kMaxSet, kMaxBigSet,
# kMaxCluster, kTileTarget, kRowPad, make_dims), csrc/fused_transformer_bf16.cu
# (kTileTarget, 16-row m-tiles, kLnVals, kMaxBigSet, split_set),
# csrc/fused_transformer_tf32x3.cu (kTileTarget, kMinTile, kSlack,
# kMaxBigSet, pick_layout) and the H100's 227 KB of shared memory per block.
# Sets up to MAX_SET rows: every kernel, a tile of whole sets.  Above, up to
# MAX_BIG_SET (the reference's largest Pallas tile of whole sets), a tile of
# one set: the bf16 pair splits it over the CLUSTER blocks of a
# thread-block cluster where the whole set's tile does not fit
# (``split_rows``); the fp32 FMA pair and the 3xTF32 forward always split
# it, over 2 blocks up to 2 MAX_SET rows and FMA_MAX_CLUSTER above
# (``fma_tile``; the 3xTF32 forward's rule, ``_f32_fwd_layout``, gives the
# same at every width where 32 rows fit).
MAX_SET = 32
MAX_BIG_SET = 128
CLUSTER = 2
FMA_MAX_CLUSTER = 4
TILE_TARGET = 32  # the fp32 backward and the FMA forward it recomputes
BF16_TILE_TARGET = 64  # both bf16 kernels
F32_TILE_TARGET = 32  # the fp32 forward; 16 where a net does not fit
F32_MIN_TILE = 16
F32_SLACK = 8  # floats past the fp32 forward's last buffer
# rows of a set above MAX_SET a block of the fp32 forward holds at most
# (kBigRows), and the blocks an SM its BIG instance's launch bounds give
# registers for (kBigBlocks; kBlocks below MAX_SET)
F32_BIG_ROWS = 32
F32_BIG_BLOCKS = 2
F32_BLOCKS = 3
# bf16 forward blocks an SM its launch bounds give registers for
# (kFwdBlocks), its BIG instance's too
FWD_BLOCKS = 2
# the same for the fp32 FMA forward (its __launch_bounds__), BIG too
FMA_FWD_BLOCKS = 2
ROW_PAD = 8  # the fp32 tiles' rows are padded to a multiple of this
MAX_HIDDEN_BF16 = 256  # LN rows held in registers, 8 values a lane
MAX_SMEM = 232_448
# the FMA pair's weight rings (csrc/fused_transformer_fma.cuh kRingSteps,
# kRingCg): 8 warps x 4 steps x 4 rows x 6 column groups x 16 bytes, taken
# wherever they fit beside a block's buffers
FMA_RING_BYTES = 8 * 4 * 4 * 6 * 16
# an H100 SM's shared memory, of which the runtime reserves 1 KB a block
SMEM_PER_SM = 233_472

NUM_W = 12
LAUNCHES = {"bfloat16": 0, "float32": 0}
BWD_LAUNCHES = {"bfloat16": 0, "float32": 0}
TRAIN_FWD_LAUNCHES = {"float32": 0}
MASKED_LAUNCHES = {"bfloat16": 0, "float32": 0}
MASKED_TRAIN_FWD_LAUNCHES = {"float32": 0}
MASKED_BWD_LAUNCHES = {"bfloat16": 0, "float32": 0}
# the fp32 pair's launches at sets above MAX_SET (over clusters)
CLUSTER_TRAIN_FWD_LAUNCHES = {"float32": 0}
CLUSTER_BWD_LAUNCHES = {"float32": 0}
# the backward's launches with regions in its global workspace
GLOBAL_H_BWD_LAUNCHES = {"bfloat16": 0, "float32": 0}
# launches of wgrad_tiles_bf16: the weight gradients of #4 bf16's global
# layout, from the operand images its backward leaves
GLOBAL_H_WGRAD_LAUNCHES = {"bfloat16": 0}
# the fp32 backward's regions that move to its workspace, in this order,
# until its tile fits (csrc/fused_transformer_fma.cuh pick_bwd_regions)
FMA_WS_REGIONS = ("copies", "mlp", "qkv")

# (source, entry point) of the forward and of the backward
_ENTRY = {torch.bfloat16: ("fused_transformer_bf16",
                           "fused_set_transformer_fwd_bf16"),
          torch.float32: ("fused_transformer_tf32x3",
                          "fused_set_transformer_fwd_f32")}
# an fp32 call with grad: the forward whose arithmetic the backward
# recomputes; at sets above MAX_SET both from the BIG source
_TRAIN_FWD_ENTRY = ("fused_transformer", "fused_set_transformer_train_fwd_f32")
_FMA_BIG = "fused_transformer_f32_big"
_BIG_TRAIN_FWD_ENTRY = (_FMA_BIG, "fused_set_transformer_train_fwd_f32_big")
_BIG_BWD_ENTRY = (_FMA_BIG, "fused_set_transformer_bwd_f32_big")
_BWD_ENTRY = {torch.bfloat16: ("fused_transformer_bf16",
                               "fused_set_transformer_bwd_bf16"),
              torch.float32: ("fused_transformer",
                              "fused_set_transformer_bwd_f32")}
# the fp32 backward with regions of its tile in the global workspace: an
# instance in a source of its own, so that it builds beside the others
_FMA_WS = "fused_transformer_f32_ws"
_WS_BWD_ENTRY = (_FMA_WS, "fused_set_transformer_bwd_f32_ws")
_KEY = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def flatten_params(net) -> tuple:
    """A SetTransformer's parameters as the reference's fixed 12-tuple:
    embed_w [IN,H], embed_b [1,H], qkv_w [L,H,3H], qkv_b [L,3H],
    proj_w [L,H,H], proj_b [L,H], fc1_w [L,H,RH], fc1_b [L,RH],
    fc2_w [L,RH,H], fc2_b [L,H], out_w [H,OUT], out_b [1,OUT]; all fp32."""
    def stack(key, part):
        return torch.stack([getattr(getattr(b, key), part)
                            for b in net.blocks])
    return (net.embed.w, net.embed.b[None, :],
            stack("qkv", "w"), stack("qkv", "b"),
            stack("proj", "w"), stack("proj", "b"),
            stack("fc1", "w"), stack("fc1", "b"),
            stack("fc2", "w"), stack("fc2", "b"),
            net.out.w, net.out.b[None, :])


def smem_bytes(set_size: int, in_dim: int, hidden: int, mlp: int,
               heads: int | None = None) -> int:
    """Dynamic shared memory of one block of the fp32 forward, as the kernel
    computes it (``heads``: above MAX_SET, as ``fwd_shape``)."""
    return _f32_fwd_layout(set_size, in_dim, hidden, mlp, heads)[1]


def conflict_free(n: int) -> int:
    """The smallest width >= n that is 4 mod 8 floats: the fp32 forward's
    A-fragment loads from rows this far apart fall in distinct banks."""
    return n + (4 - n) % 8


def split_rows(set_size: int, cluster: int) -> int:
    """Rows of a set above MAX_SET in each block but the last (which holds
    the rest) where it spans ``cluster`` blocks: ceil(set_size /
    cluster)."""
    return -(-set_size // cluster)


def _f32_fwd_layout(set_size: int, in_dim: int, hidden: int, mlp: int,
                    heads: int | None) -> tuple[int, int, int]:
    """(tile, shared-memory bytes, blocks a set spans) of the fp32 forward:
    the first that fits of whole sets up to 32 rows with conflict-free
    rows, whole sets up to 16 rows (one set where a set is larger) with
    conflict-free rows, and the same with rows at their true width; a set
    above MAX_SET rows over the fewest of 1, 2 and FMA_MAX_CLUSTER blocks
    of a cluster that keeps ``split_rows`` of it a block within
    F32_BIG_ROWS, with conflict-free rows, then at their true width; the
    last when none fits.  Three buffers: h and the LN/attention output
    [tile, H], and the widest of x, qkv and the MLP hidden layer, plus the
    slack that the padded contraction of the last row reads; above
    MAX_SET the stage of a block's share of the heads (ceil(heads /
    cluster) of them), their q, k and v for the whole set [3, set_size,
    ld(share x head width)], so there the layout needs ``heads``
    (``pick_layout``, ``layout_fits`` in the kernel)."""
    if set_size > MAX_BIG_SET:  # ROADMAP B16
        return set_size, MAX_SMEM + 1, FMA_MAX_CLUSTER
    if set_size > MAX_SET:
        if heads is None:
            raise ValueError("the fp32 forward's layout of a set above "
                             f"{MAX_SET} rows depends on its heads")
        choices = [(split_rows(set_size, cl), ld, cl)
                   for cl in (1, 2, FMA_MAX_CLUSTER)
                   if split_rows(set_size, cl) <= F32_BIG_ROWS
                   for ld in (conflict_free, int)]
    else:
        choices = [(_tile(set_size, tt, 1)[0], ld, 1) for tt, ld in
                   ((F32_TILE_TARGET, conflict_free),
                    (F32_MIN_TILE, conflict_free), (F32_MIN_TILE, int))]
    for tile, ld, cluster in choices:
        ld_big = max(ld(in_dim), ld(3 * hidden), ld(mlp))
        smem = 4 * (tile * (2 * ld(hidden) + ld_big) + F32_SLACK)
        if set_size > MAX_SET:
            share = -(-heads // cluster) * (hidden // heads)
            smem += 4 * 3 * set_size * ld(share)
        if smem <= MAX_SMEM:
            break
    return tile, smem, cluster


def _tile(set_size: int, target: int = TILE_TARGET,
          pad: int = ROW_PAD) -> tuple[int, int]:
    tile = max(1, target // set_size) * set_size
    return tile, -(-tile // pad) * pad


def fma_tile(set_size: int) -> tuple[int, int, int]:
    """(rows of a tile, the tile padded to ROW_PAD, blocks a set spans) of
    the fp32 FMA pair, both kernels alike (``make_dims``): whole sets up to
    TILE_TARGET rows for sets up to MAX_SET; above, one set over a cluster
    of 2 blocks up to 2 MAX_SET rows and of FMA_MAX_CLUSTER above,
    ``split_rows`` of it a block (so at most 32 rows a block up to
    MAX_BIG_SET)."""
    if set_size <= MAX_SET:
        return (*_tile(set_size), 1)
    cluster = 2 if set_size <= 2 * MAX_SET else FMA_MAX_CLUSTER
    tile = split_rows(set_size, cluster)
    return tile, -(-tile // ROW_PAD) * ROW_PAD, cluster


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def bwd_layout(dtype: torch.dtype, set_size: int, in_dim: int, hidden: int,
               mlp: int, out_dim: int, heads: int, layers: int,
               global_h: bool = False) -> tuple:
    """(rows of a tile, dynamic shared memory of one block, what lives in
    global memory, blocks a set spans) of the backward, as the kernel picks
    them.  bf16: whole sets up to 64 rows, padded to 16-row m-tiles, rows
    of bf16 a multiple of 16 plus 8 wide; 32-row tiles where 64 do not fit
    (nets wider or deeper than the flagship); where neither fits, or with
    ``global_h``, the same tiles with the residual stream's copies at the
    block boundaries in a global workspace (``h_workspace_elems``) and one
    in shared memory; the third item says whether they are.  A set above
    MAX_SET rows is a tile of its own, the residual copies in shared
    memory: the whole set where it is at most BF16_TILE_TARGET rows and
    fits, else ``split_rows`` of it on each block of a cluster of two
    (``split_set`` in the kernel); ``global_h`` is refused there.  fp32:
    ``fma_tile``'s tile (up to 32 rows) padded to 8, rows
    ``conflict_free`` wide (x's a multiple of 4), the first regions of
    ``FMA_WS_REGIONS`` (the copies, the MLP pair, qkv) in a global
    workspace (``fma_workspace_elems``) with which the rest fits, none where
    all fits, all three with ``global_h``; the third item names them
    (``pick_bwd_regions`` in ``csrc/fused_transformer_fma.cuh``).  A set
    above MAX_SET rows takes the layout all in shared memory (its instance
    has no workspace; ``global_h`` is refused there).  Both hold the
    residual stream at each of the layers + 1 block boundaries (or one),
    five [tile, H] buffers, qkv, a region for the MLP pair / the qkv
    gradient / g / x, and the fp32 softmax statistics; the fp32 block also
    its warps' weight rings where they fit (``with_rings``).  A set above
    MAX_BIG_SET fits nowhere (ROADMAP B16).  Where nothing fits the last
    layout is returned, over MAX_SMEM."""
    if dtype != torch.bfloat16:
        if set_size > MAX_BIG_SET or (global_h and set_size > MAX_SET):
            return set_size, MAX_SMEM + 1, (), FMA_MAX_CLUSTER
        tile, tile_pad, cluster = fma_tile(set_size)
        ld_h, ld_big, ld_f = (conflict_free(n)
                              for n in (hidden, 3 * hidden, mlp))
        ld_rest = max(ld_big, conflict_free(out_dim), pad4(in_dim))
        for ws in range(3 if global_h else 0, 4 if cluster == 1 else 1):
            copies = 1 if ws >= 1 else layers + 1
            ld_r2 = ld_rest if ws >= 2 else max(2 * ld_f, ld_rest)
            smem = 4 * tile_pad * ((copies + 5) * ld_h
                                   + (0 if ws >= 3 else ld_big) + ld_r2
                                   + 3 * heads)
            if smem <= MAX_SMEM:
                break
        return tile, with_rings(smem), FMA_WS_REGIONS[:ws], cluster
    ld_h, ld_big, ld_f = (pad16(n) + 8 for n in (hidden, 3 * hidden, mlp))
    ld_r2 = max(2 * ld_f, ld_big, pad16(out_dim) + 8, pad16(in_dim) + 8)
    globals_ = (True,) if global_h else (False, True)
    if set_size > MAX_SET:
        if global_h:
            return set_size, MAX_SMEM + 1, True, 1
        choices = [(split_rows(set_size, cl), False, cl) for cl in (1, CLUSTER)
                   if pad16(split_rows(set_size, cl)) <= BF16_TILE_TARGET]
        if not choices:  # above MAX_BIG_SET (ROADMAP B16)
            return set_size, MAX_SMEM + 1, False, CLUSTER
    else:
        choices = [(_tile(set_size, target, 16)[0], g, 1) for g in globals_
                   for target in (BF16_TILE_TARGET, BF16_TILE_TARGET // 2)]
    for tile, in_global, cluster in choices:
        copies = 1 if in_global else layers + 1
        tile_pad = pad16(tile)
        smem = (2 * tile_pad * ((copies + 5) * ld_h + ld_big + ld_r2)
                + 4 * tile_pad * 3 * heads)
        if smem <= MAX_SMEM:
            break
    return tile, smem, in_global, cluster


def bf16_big_stage(set_size: int, hidden: int, cluster: int) -> tuple:
    """(bytes, room) of #4 bf16's staged copy of the other block's rows where
    a set above MAX_SET spans a cluster of two (``stage_other`` in
    ``csrc/fused_transformer_bf16.cu``): at most ``split_rows`` rows of K
    and V, or of Q and the output cotangent, 2 x hidden bf16 a row,
    ``pad16(2 hidden) + 8`` wide; and the two adjacent [tile_pad, ld_h]
    buffers of its tile that a pass leaves dead and the copy goes to (the
    attention output and h after it in phase 1 and 2, h after it and the
    cotangent buffer in the recompute).  No copy at one block.  #3 bf16
    stages K and V alike, in the region of its attention output
    (``fwd_shape``)."""
    tile = split_rows(set_size, cluster)
    rows = tile if cluster > 1 else 0
    return (2 * rows * (pad16(2 * hidden) + 8),
            2 * 2 * pad16(tile) * (pad16(hidden) + 8))


def h_workspace_elems(tile: int, hidden: int, layers: int, grid: int) -> int:
    """bf16 elements of the bf16 backward's global workspace of residual
    copies: for each of ``grid`` blocks, h at the block boundaries 0 ..
    layers - 1, each a [pad16(tile), pad16(hidden) + 8] image."""
    return grid * layers * pad16(tile) * (pad16(hidden) + 8)


def stash_workspace_elems(tile: int, hidden: int, layers: int, mlp: int,
                          grid: int) -> int:
    """bf16 elements that the bf16 backward's global layout keeps after its
    residual copies: for each of ``grid`` blocks and each layer, the
    forward's qkv, attention output, h after it, and MLP pair f | m, whole
    [pad16(tile), width padded to 16 + 8] images (``stash`` in the kernel),
    read back in place of their recompute."""
    ld = lambda n: pad16(n) + 8  # noqa: E731
    return grid * layers * pad16(tile) * (ld(3 * hidden) + 2 * ld(hidden)
                                          + 2 * ld(mlp))


def weight_shapes(in_dim: int, hidden: int, layers: int, mlp: int,
                  out_dim: int) -> list:
    """The shapes of ``flatten_params``' 12 weights of a net."""
    H, L, RH = hidden, layers, mlp
    return [(in_dim, H), (1, H), (L, H, 3 * H), (L, 3 * H), (L, H, H),
            (L, H), (L, H, RH), (L, RH), (L, RH, H), (L, H), (H, out_dim),
            (1, out_dim)]


class WgradShape(NamedTuple):
    """The call of #4 bf16 whose weight gradients ``wgrad_tiles_bf16``
    computes: x's rows, set size and width, and the net's widths."""
    rows: int
    set_size: int
    in_dim: int
    hidden: int
    layers: int
    mlp: int
    out_dim: int

    def weight_shapes(self) -> list:
        return weight_shapes(self.in_dim, self.hidden, self.layers, self.mlp,
                             self.out_dim)


def wgrad_images(shape: WgradShape) -> list:
    """(name, width) of each operand image of a tile, in the order of
    ``Images`` in ``csrc/fused_transformer_bf16.cu``: each a [pad16(tile),
    width] bf16 image, width the operand's padded to 16; x, g, the output
    layer's input ``a_out`` and the embed's cotangent, then each layer's a1,
    o, a2, m and the cotangents into fc2, fc1, proj and qkv (names with the
    layer after a colon)."""
    H, RH = pad16(shape.hidden), pad16(shape.mlp)
    out = [("x", pad16(shape.in_dim)), ("g", pad16(shape.out_dim)),
           ("a_out", H), ("g_embed", H)]
    for layer in range(shape.layers):
        out += [(f"{name}:{layer}", w) for name, w in (
            ("a1", H), ("o", H), ("a2", H), ("m", RH), ("g_fc2", H),
            ("g_fc1", RH), ("g_proj", H), ("g_qkv", pad16(3 * shape.hidden)))]
    return out


def wgrad_workspace_elems(shape: WgradShape, tile: int) -> int:
    """bf16 elements of the operand images #4 bf16's global layout leaves
    for ``wgrad_tiles_bf16``: every tile of ``tile`` rows, each image
    ``pad16(tile)`` rows (``wgrad_images``)."""
    tiles = -(-shape.rows // tile)
    return tiles * pad16(tile) * sum(w for _, w in wgrad_images(shape))


def wgrad_products(shape: WgradShape) -> list:
    """The ten products of the weight gradients in ``flatten_params``
    order, each (X's image, G's image, kd, n): the embed, each layer's qkv,
    proj, fc1 and fc2 (layer-stacked in that order within each matrix), the
    output layer."""
    H, RH, L = shape.hidden, shape.mlp, shape.layers
    layered = [(f"a1:{i}", f"g_qkv:{i}", H, 3 * H) for i in range(L)] \
        + [(f"o:{i}", f"g_proj:{i}", H, H) for i in range(L)] \
        + [(f"a2:{i}", f"g_fc1:{i}", H, RH) for i in range(L)] \
        + [(f"m:{i}", f"g_fc2:{i}", RH, H) for i in range(L)]
    return ([("x", "g_embed", shape.in_dim, H)] + layered
            + [("a_out", "g", H, shape.out_dim)])


def wgrad_tiles_plain(images, shape: WgradShape, tile: int, grid: int,
                      round_matrices: bool = True) -> torch.Tensor:
    """The plain version of ``wgrad_tiles_bf16``: the 12 weight gradients
    (flat fp32, ``flatten_params`` order, the matrices rounded to bf16) from
    the operand images ``images`` (``wgrad_images``) of every tile: each
    tile's X^T G and G's column sums in fp32, summed over the tiles as the
    kernel sums them (each slice b < ``grid`` its tiles b, b + grid, ... in
    order, then the slices in order), the products' own sums in torch's
    order; with ``round_matrices`` false the matrices' sums unrounded.
    ``wgrad_tiles_bf16`` takes it for CPU images: the tests and
    ``chip_smoke.py`` call it, no path of the port."""
    tp, tiles = pad16(tile), -(-shape.rows // tile)
    offsets, at = {}, 0
    for name, w in wgrad_images(shape):
        offsets[name] = (at, w)
        at += tp * w
    per_tile = images.view(tiles, at)

    def image(name, width):
        off, w = offsets[name]
        return per_tile[:, off:off + tp * w].view(tiles, tp, w)[
            :, :, :width].float()

    def in_order(a):
        # slice b's tiles b, b + grid, ... summed in order (zeros past the
        # last tile), then the slices in order
        pad = -(-tiles // grid) * grid - tiles
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]).view(
            -1, grid, *a.shape[1:])
        part = a[0]
        for j in range(1, a.shape[0]):
            part = part + a[j]
        total = torch.zeros_like(part[0])
        for b in range(grid):
            total = total + part[b]
        return total

    ws, bs = [], []
    for xi, gi, kd, n in wgrad_products(shape):
        x, g = image(xi, kd), image(gi, n)
        w = in_order(x.transpose(1, 2) @ g)
        ws.append((w.to(torch.bfloat16).float() if round_matrices
                   else w).flatten())
        bs.append(in_order(g.sum(1)))
    L = shape.layers
    # flatten_params: embed w, b; qkv, proj, fc1, fc2 each w then b, their
    # layers stacked; out w, b
    flat = [ws[0], bs[0]]
    for j in range(4):
        flat += [torch.cat(ws[1 + j * L:1 + (j + 1) * L]),
                 torch.cat(bs[1 + j * L:1 + (j + 1) * L])]
    return torch.cat(flat + [ws[-1], bs[-1]])


def wgrad_tiles_bf16(images, shape: WgradShape, tile: int, grid: int,
                     dw=None) -> torch.Tensor:
    """``wgrad_tiles`` of ``csrc/fused_transformer_bf16.cu`` on the operand
    images ``images`` (bf16, CUDA, ``wgrad_workspace_elems``) that #4
    bf16's global layout left at ``tile`` rows a tile: the 12 weight
    gradients into ``dw`` (flat fp32, allocated if None), summed in the
    order of that call's ``grid`` slices.  CPU images take its plain
    version, ``wgrad_tiles_plain``."""
    if images.dtype != torch.bfloat16 or \
            images.numel() != wgrad_workspace_elems(shape, tile):
        raise ValueError("wgrad_tiles_bf16: images must be a bf16 tensor of "
                         f"{wgrad_workspace_elems(shape, tile)} elements")
    if not images.is_cuda:
        return wgrad_tiles_plain(images, shape, tile, grid)
    total = sum(math.prod(s) for s in shape.weight_shapes())
    if dw is None:
        dw = torch.empty(total, dtype=torch.float32, device=images.device)
    with torch.cuda.device(images.device):
        fn = _fn("fused_transformer_bf16", "wgrad_tiles_bf16", _WGRAD_ARGS)
        err = fn(images.data_ptr(), dw.data_ptr(), shape.rows,
                 shape.set_size, shape.in_dim, shape.hidden, shape.layers,
                 shape.mlp, shape.out_dim, tile, grid,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "wgrad_tiles_bf16")
    GLOBAL_H_WGRAD_LAUNCHES["bfloat16"] += 1
    return dw


def fma_workspace_elems(regions: tuple, tile: int, hidden: int, mlp: int,
                        layers: int, grid: int) -> int:
    """fp32 elements of the fp32 backward's global workspace holding
    ``regions`` (``bwd_layout``'s): for each of ``grid`` blocks, h at the
    block boundaries 0 .. layers - 1, the MLP pair f | m and qkv, each a
    [tile padded to 8, conflict_free(width)] image (``ws_floats`` in the
    kernel)."""
    tile_pad = -(-tile // ROW_PAD) * ROW_PAD
    widths = {"copies": layers * conflict_free(hidden),
              "mlp": 2 * conflict_free(mlp),
              "qkv": conflict_free(3 * hidden)}
    return grid * tile_pad * sum(widths[r] for r in regions)


def fwd_shape(dtype: torch.dtype, set_size: int, in_dim: int, hidden: int,
              mlp: int, heads: int | None = None) -> tuple[int, int, int]:
    """(rows of a tile, dynamic shared memory of one block, blocks a set
    spans) of the forward, as the kernel picks them.  bf16: whole sets up
    to 64 rows, padded to 16-row m-tiles, or up to 32 where 64 would not
    fit (nets much wider than the flagship); a set above MAX_SET rows
    whole where it is at most BF16_TILE_TARGET rows and fits, else
    ``split_rows`` of it on each block of a cluster of two;
    three bf16 buffers, h and the LN/attention output [tile, H] and the
    region for x, qkv or the MLP hidden layer, rows a multiple of 16 plus 8
    wide; over a cluster the LN/attention output's region also holds the
    other block's K and V during the attention (``bf16_big_stage``'s
    bytes; the output goes over Q meanwhile) and is the larger of the two
    (``fwd_smem_bytes`` in the kernel).  fp32: ``_f32_fwd_layout``'s, which
    above MAX_SET needs ``heads``."""
    if dtype != torch.bfloat16:
        return _f32_fwd_layout(set_size, in_dim, hidden, mlp, heads)
    ld_h = pad16(hidden) + 8
    ld_big = max(pad16(n) + 8 for n in (3 * hidden, mlp, in_dim))
    if set_size > MAX_SET:
        choices = [(split_rows(set_size, cl), cl) for cl in (1, CLUSTER)
                   if pad16(split_rows(set_size, cl)) <= BF16_TILE_TARGET]
        if not choices:  # above MAX_BIG_SET (ROADMAP B16)
            return set_size, MAX_SMEM + 1, CLUSTER
    else:
        choices = [(_tile(set_size, target, 16)[0], 1)
                   for target in (BF16_TILE_TARGET, BF16_TILE_TARGET // 2)]
    for tile, cluster in choices:
        a = max(2 * pad16(tile) * ld_h,
                bf16_big_stage(set_size, hidden, cluster)[0])
        smem = 2 * pad16(tile) * (ld_h + ld_big) + a
        if smem <= MAX_SMEM:
            break
    return tile, smem, cluster


def fma_fwd_shape(set_size: int, in_dim: int, hidden: int,
                  mlp: int) -> tuple[int, int, int]:
    """(rows of a tile, dynamic shared memory of one block, blocks a set
    spans) of the fp32 FMA forward of a differentiable call, as
    ``make_dims`` and ``fwd_smem`` lay them out: the backward's tile and
    cluster (``fma_tile``), and h, the LN/attention output and the widest
    of x, qkv and the MLP hidden layer, rows ``conflict_free`` wide (x's a
    multiple of 4), and the weight rings (``with_rings``)."""
    tile, tile_pad, cluster = fma_tile(set_size)
    big = max(conflict_free(3 * hidden), conflict_free(mlp), pad4(in_dim))
    return tile, with_rings(4 * tile_pad * (2 * conflict_free(hidden)
                                            + big)), cluster


def with_rings(smem: int) -> int:
    """An FMA block's shared memory with its warps' weight rings
    (FMA_RING_BYTES) where they fit beside its ``smem`` bytes of buffers,
    as ``with_rings`` in the kernel; without them where they do not."""
    return smem + FMA_RING_BYTES if smem + FMA_RING_BYTES <= MAX_SMEM else smem


def fwd_blocks_per_sm(smem: int) -> int:
    """Blocks of the bf16 forward an SM holds: as many as its shared memory
    allows, up to the FWD_BLOCKS its launch bounds give registers for."""
    return min(FWD_BLOCKS, smem_blocks_per_sm(smem))


def smem_blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory that fit on an SM."""
    return max(1, SMEM_PER_SM // (smem + 1024))


def f32_fwd_blocks_per_sm(set_size: int, smem: int) -> int:
    """Blocks of the fp32 forward an SM holds: as many as its shared memory
    allows, up to what its instance's launch bounds give registers for
    (F32_BIG_BLOCKS above MAX_SET, else F32_BLOCKS)."""
    bound = F32_BIG_BLOCKS if set_size > MAX_SET else F32_BLOCKS
    return min(bound, smem_blocks_per_sm(smem))


def bwd_grid(rows: int, tile: int, smem: int, sms: int,
             set_size: int = 0, cluster: int = 1,
             max_clusters: int | None = None) -> int:
    """Persistent blocks of the backward: as many as fit on the card at
    once, never more than there are tiles; where a set spans a cluster of
    blocks, a multiple of the cluster, never more than one cluster a set:
    ``max_clusters`` clusters where the card was asked how many it holds
    at once (``cudaOccupancyMaxActiveClusters``), else as many as the SMs'
    shared memory holds.  Only the fp32 pair asks the card: the SM rule
    overcounts its clusters of 4 (it would give 33 on an H100, which holds
    30).  #4 bf16's clusters of 2 keep the SM rule, because the grid fixes
    the order in which the weight gradients' per-block partials are summed,
    so their bits, which ``chip_smoke.py``'s digests pin.  Whether the card
    would give bf16's layout the same 66 clusters of 2 has not been
    asked."""
    if cluster > 1:
        sets = rows // set_size
        if max_clusters is None:
            max_clusters = sms * smem_blocks_per_sm(smem) // cluster
        return cluster * max(1, min(sets, max_clusters))
    return max(1, min(-(-rows // tile), sms * smem_blocks_per_sm(smem)))


def bwd_launch(dtype: torch.dtype, set_size: int, in_dim: int, hidden: int,
               mlp: int, out_dim: int, heads: int, layers: int, rows: int,
               sms: int, global_h: bool = False,
               max_clusters: int | None = None) -> tuple:
    """(tile, shared memory, what lives in global memory, grid) of a
    backward launch on ``rows`` rows over ``sms`` SMs: ``bwd_layout``'s,
    and ``bwd_grid``'s grid (``max_clusters`` as there).  A layout forced
    global (``global_h``) keeps the default layout's grid, so the weight
    gradients' slices are summed in the same order."""
    net = (dtype, set_size, in_dim, hidden, mlp, out_dim, heads, layers)
    tile, smem, in_global, cluster = bwd_layout(*net, global_h)
    grid = bwd_grid(rows, tile, bwd_layout(*net)[1] if global_h else smem,
                    sms, set_size, cluster, max_clusters)
    return tile, smem, in_global, grid


def pad4(n: int) -> int:
    return -(-n // 4) * 4


def padded_layouts(mats, dtype: torch.dtype | None = None,
                   pad=pad16) -> list:
    """The operand layouts of the weights ``mats`` (each W [..., kd, n], any
    device), cast to ``dtype`` (by default theirs) and zero-padded to
    multiples of ``pad``'s: the 6 layouts W^T [..., pad(n), pad(kd)], then
    the 6 layouts W [..., pad(kd), pad(n)].  Each is contiguous.  With
    ``pad16`` they are the bf16 kernels': W^T the B operands of the
    products x @ W, W those of g @ W^T, rows along the output, so a
    tensor-core fragment reads two neighbouring contraction values at once.
    With ``pad4`` they are the fp32 FMA pair's (``csrc/fused_transformer.cu``
    ``FmaWeights``): W for the forward products, W^T for the input
    gradients, each read as a float4 of 4 outputs a contraction step.  They
    are views of one zeroed buffer: one fill, and one copy a layout, which
    casts."""
    shapes = []
    for w in mats:
        *lead, kd, n = w.shape
        shapes.append(((*lead, pad(n), pad(kd)),
                       (*lead, pad(kd), pad(n))))
    fwd_shapes, bwd_shapes = zip(*shapes)
    shapes = list(fwd_shapes + bwd_shapes)
    sizes = [math.prod(shape) for shape in shapes]
    buf = torch.zeros(sum(sizes), dtype=dtype or mats[0].dtype,
                      device=mats[0].device)
    views = [v.view(shape) for v, shape in zip(buf.split(sizes), shapes)]
    for w, fwd, bwd in zip(mats, views[:len(mats)], views[len(mats):]):
        kd, n = w.shape[-2:]
        fwd[..., :n, :kd].copy_(w.detach().transpose(-1, -2))
        bwd[..., :kd, :n].copy_(w.detach())
    return views


def rna_tf32(w: torch.Tensor) -> torch.Tensor:
    """fp32 ``w`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: the low 13 bits zero."""
    bits = w.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pad8(n: int) -> int:
    return -(-n // 8) * 8


def tf32x3_layouts(mats) -> list:
    """The fp32 forward's operand layouts of the weights ``mats`` (each W
    [..., kd, n], fp32, any device): W^T split into a TF32 high part hi =
    rna(W^T) and a TF32 remainder lo = rna(W^T - hi), zero-padded to
    [..., pad8(n), pad8(kd)], interleaved for the m16n8k8 B fragment as
    [..., pad8(n), 2 pad8(kd)]: the 16 floats of output row c and k-step s
    are, for t < 4, hi[8s + t], hi[8s + t + 4], lo[8s + t], lo[8s + t + 4],
    so that lane t reads its high and low fragments as one 16-byte load.
    Views of one buffer."""
    shapes = [(*w.shape[:-2], pad8(w.shape[-1]), 2 * pad8(w.shape[-2]))
              for w in mats]
    sizes = [math.prod(shape) for shape in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=mats[0].device)
    views = [v.view(shape) for v, shape in zip(buf.split(sizes), shapes)]
    for w, out in zip(mats, views):
        *lead, kd, n = w.shape
        wt = torch.zeros(*lead, pad8(n), pad8(kd), dtype=torch.float32,
                         device=w.device)
        wt[..., :n, :kd] = w.detach().transpose(-1, -2)
        hi = rna_tf32(wt)
        lo = rna_tf32(wt - hi)
        # [..., n8, k-steps, half (k % 8 >= 4), t] -> [..., t, hi/lo, half]
        split = torch.stack([p.unflatten(-1, (-1, 2, 4)).transpose(-1, -2)
                             for p in (hi, lo)], dim=-2)
        out.copy_(split.flatten(-4))
    return views


def supported(x, cond, mask, hidden_dim: int, num_heads: int,
              mlp_ratio: int = 2,
              compute_dtype: torch.dtype = torch.float32) -> bool:
    """Whether the forward kernel of ``compute_dtype`` covers this call: no
    cond, x [B, S, IN] with S <= MAX_BIG_SET (128), a key mask (if any) of
    shape [B, S], heads dividing the width, in bf16 a width of at most 256,
    and a tile that fits.  The forward's limits only: the backward's tile
    is larger (``bwd_fits``); a differentiable fp32 call takes the FMA
    pair, at sets above MAX_SET over clusters (``fma_fwd_shape``)."""
    if cond is not None or x.dim() != 3:
        return False
    if mask is not None and tuple(mask.shape) != tuple(x.shape[:2]):
        return False
    if hidden_dim % num_heads != 0 or not 1 <= x.shape[1] <= MAX_BIG_SET:
        return False
    if compute_dtype == torch.bfloat16 and hidden_dim > MAX_HIDDEN_BF16:
        return False
    smem = fwd_shape(compute_dtype, x.shape[1], x.shape[2], hidden_dim,
                     mlp_ratio * hidden_dim, num_heads)[1]
    return smem <= MAX_SMEM


def bwd_fits(dtype: torch.dtype, set_size: int, in_dim: int, hidden: int,
             mlp: int, out_dim: int, heads: int, layers: int) -> bool:
    """Whether a tile of the backward kernel fits in shared memory."""
    return bwd_layout(dtype, set_size, in_dim, hidden, mlp, out_dim, heads,
                      layers)[1] <= MAX_SMEM


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# a forward and a backward without a key mask (the 3xTF32 #4 of
# tools/f32_bwd_tf32x3.cu)
_FWD_ARGS = [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
             _P]
# the entries that take a key mask, the pointer after x's: every forward
# and both backwards; each backward also takes its global workspace after
# dw and its layout switch after grid
_MASKED_FWD_ARGS = _FWD_ARGS[:1] + [_P] + _FWD_ARGS[1:]
_MASKED_BWD_ARGS = (_BWD_ARGS[:1] + [_P] + _BWD_ARGS[1:7] + [_P]
                    + _BWD_ARGS[7:-1] + [_I, _P])
_FMA_BWD_ARGS = _MASKED_BWD_ARGS
# wgrad_tiles_bf16: images, dw, rows, the net's widths, tile, grid, stream
_WGRAD_ARGS = [_P, _P, _L] + [_I] * 8 + [_P]
# sets the FMA pair's shared-memory limit once a device, by source
_FMA_INIT = {"fused_transformer": "fused_set_transformer_f32_init",
             _FMA_WS: "fused_set_transformer_f32_ws_init",
             _FMA_BIG: "fused_set_transformer_f32_big_init"}
_FMA_CLUSTERS = "fused_set_transformer_f32_big_clusters"
_fns: dict = {}
_fma_ready: set = set()
_fma_clusters: dict = {}


def _fn(source: str, name: str, argtypes):
    """Entry point ``name`` of ``csrc/<source>.cu``, typed on first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(source), name)
        fn.argtypes, fn.restype = argtypes, _I
        _fns[name] = fn
    return fn


def _fma_fn(source: str, name: str, argtypes, device):
    """Entry ``name`` of the FMA pair's ``csrc/<source>.cu``
    (``fused_transformer``, ``fused_transformer_f32_ws`` or
    ``fused_transformer_f32_big``), its kernels'
    shared-memory limit raised on ``device`` at the first call there (the
    current device, as every launch here)."""
    fn = _fn(source, name, argtypes)
    key = (source, torch.device(device).index)
    if key not in _fma_ready:
        init = _FMA_INIT[source]
        build.check(_fn(source, init, [])(), init)
        _fma_ready.add(key)
    return fn


def fma_max_clusters(device, set_size: int, in_dim: int, hidden: int,
                     heads: int, layers: int, mlp: int, out_dim: int) -> int:
    """Clusters of the fp32 backward at a set above MAX_SET that the card
    ``device`` holds at once (``cudaOccupancyMaxActiveClusters`` at its
    layout), asked once a device and net."""
    key = (torch.device(device).index, set_size, in_dim, hidden, heads,
           layers, mlp, out_dim)
    if key not in _fma_clusters:
        fn = _fma_fn(_FMA_BIG, _FMA_CLUSTERS,
                     [_I] * 7 + [ctypes.POINTER(ctypes.c_int)], device)
        n = ctypes.c_int(0)
        build.check(fn(*key[1:], ctypes.byref(n)), _FMA_CLUSTERS)
        _fma_clusters[key] = n.value
    return _fma_clusters[key]


def pack_matrices(ws, compute_dtype: torch.dtype) -> tuple[list, list]:
    """The matrices of the 12-tuple ``ws`` (fp32) as the kernels of
    ``compute_dtype`` read them: (the forward's, the backward's).  fp32: the
    6 ``tf32x3_layouts`` for the forward, the 6 fp32 matrices for the
    backward (``PackedWeights`` pads them for the FMA pair).  bf16: the 12
    ``padded_layouts``, cast straight from fp32 (one fill and 12 casting
    copies a repack); the forward reads the 6 W^T layouts, the backward all
    12."""
    mats = [ws[j].detach() for j in (0, 2, 4, 6, 8, 10)]
    if compute_dtype != torch.bfloat16:
        mats = [m.to(compute_dtype).contiguous() for m in mats]
        return tf32x3_layouts(mats), mats
    layouts = padded_layouts(mats, compute_dtype)
    return layouts[:6], layouts


class PackedWeights:
    """The 12-tuple ``ws`` (fp32, on the card) checked and made ready for
    the kernels once: the matrices as ``pack_matrices`` lays them out (in
    fp32 also the FMA pair's 12 ``padded_layouts`` at ``pad4``), the 6 fp32
    biases contiguous, and their pointers; reused by every launch of the
    forward and the backward."""

    def __init__(self, ws, compute_dtype: torch.dtype):
        if compute_dtype not in _ENTRY:
            raise TypeError(f"fused SetTransformer: no kernel for "
                            f"{compute_dtype}")
        if len(ws) != NUM_W:
            raise ValueError(f"fused SetTransformer: {len(ws)} weights, "
                             f"want {NUM_W}")
        embed_w, qkv_w, fc1_w, out_w = ws[0], ws[2], ws[6], ws[10]
        self.in_dim, self.hidden = embed_w.shape
        self.layers, self.mlp = qkv_w.shape[0], fc1_w.shape[2]
        self.out_dim = out_w.shape[1]
        want = weight_shapes(self.in_dim, self.hidden, self.layers,
                             self.mlp, self.out_dim)
        self.device = embed_w.device
        for j, (t, shape) in enumerate(zip(ws, want)):
            if tuple(t.shape) != shape:
                raise ValueError(f"fused SetTransformer: weight {j} has shape "
                                 f"{tuple(t.shape)}, want {shape}")
            if not t.is_cuda or t.device != self.device:
                raise ValueError("fused SetTransformer: weights must be CUDA "
                                 "tensors on one device")
            if t.dtype != torch.float32:
                raise TypeError("fused SetTransformer: weights must be fp32")
        if self.mlp % self.hidden:
            raise ValueError(f"fused SetTransformer: MLP width {self.mlp} is "
                             f"not a multiple of H={self.hidden}")
        self.dtype = compute_dtype
        self.shapes = tuple(tuple(t.shape) for t in ws)
        with torch.no_grad():
            self.mats, self.bwd_mats = pack_matrices(ws, compute_dtype)
            self.biases = [ws[j].detach().contiguous()
                           for j in (1, 3, 5, 7, 9, 11)]
            self.fma_mats = (padded_layouts(self.bwd_mats, pad=pad4)
                             if compute_dtype == torch.float32 else [])
        self.w_ptrs = _ptrs(self.mats)
        self.bwd_w_ptrs = _ptrs(self.bwd_mats)
        self.fma_w_ptrs = _ptrs(self.fma_mats)
        self.b_ptrs = _ptrs(self.biases)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_x(packed: PackedWeights, x, num_heads: int, what: str,
             mask=None):
    if not x.is_cuda or x.dim() != 3:
        raise ValueError(f"fused SetTransformer {what}: x must be a "
                         "[B, S, IN] CUDA tensor")
    if x.device != packed.device:
        raise ValueError(f"fused SetTransformer {what}: x on {x.device}, "
                         f"weights on {packed.device}")
    if (x.shape[2] != packed.in_dim
            or not supported(x, None, None, packed.hidden, num_heads,
                             packed.mlp // packed.hidden, packed.dtype)):
        raise ValueError(f"fused SetTransformer {what}: unsupported call x "
                         f"{tuple(x.shape)}, H={packed.hidden}, "
                         f"heads={num_heads}" + (
                             f" (sets above {MAX_BIG_SET} rows: ROADMAP.md, "
                             f"B16)" if x.shape[1] > MAX_BIG_SET else ""))
    if mask is not None and (tuple(mask.shape) != tuple(x.shape[:2])
                             or mask.device != x.device):
        raise ValueError(f"fused SetTransformer {what}: key mask "
                         f"{tuple(mask.shape)} on {mask.device}, want "
                         f"{tuple(x.shape[:2])} on {x.device}")


def key_mask_bytes(mask):
    """A key mask [B, S] (float or bool, nonzero = valid) as the kernels
    read it: one byte a key, contiguous; None stays None."""
    if mask is None:
        return None
    return (mask.detach() != 0).to(torch.uint8).contiguous()


def _mask_ptr(km) -> int | None:
    return None if km is None else km.data_ptr()


def _forward_launch(packed: PackedWeights, x, num_heads: int,
                    differentiable: bool = False, mask=None):
    """Kernel #3.  A differentiable fp32 call takes the FMA forward whose
    arithmetic the fp32 backward recomputes (bf16 has one forward), at a
    set above MAX_SET its instance over clusters."""
    _check_x(packed, x, num_heads, "forward", mask)
    train = differentiable and packed.dtype == torch.float32
    B, S, in_dim = x.shape
    big = train and S > MAX_SET
    x2 = x.detach().to(packed.dtype).contiguous()
    km = key_mask_bytes(mask)
    y = torch.empty(B, S, packed.out_dim, dtype=packed.dtype, device=x.device)
    source, name = (_BIG_TRAIN_FWD_ENTRY if big else _TRAIN_FWD_ENTRY
                    ) if train else _ENTRY[packed.dtype]
    with torch.cuda.device(x.device):
        fn = (_fma_fn(source, name, _MASKED_FWD_ARGS, x.device) if train
              else _fn(source, name, _MASKED_FWD_ARGS))
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x2.data_ptr(), _mask_ptr(km),
                 packed.fma_w_ptrs if train else packed.w_ptrs,
                 packed.b_ptrs, y.data_ptr(), B * S, S, in_dim,
                 packed.hidden, num_heads, packed.layers, packed.mlp,
                 packed.out_dim, stream)
    build.check(err, name)
    if train:
        (CLUSTER_TRAIN_FWD_LAUNCHES if big else TRAIN_FWD_LAUNCHES
         )["float32"] += 1
        if km is not None:
            MASKED_TRAIN_FWD_LAUNCHES["float32"] += 1
    else:
        LAUNCHES[_KEY[packed.dtype]] += 1
        if km is not None:
            MASKED_LAUNCHES[_KEY[packed.dtype]] += 1
    return y


def fused_set_transformer(packed: PackedWeights, x, *, num_heads: int,
                          mask=None) -> torch.Tensor:
    """The whole SetTransformer on x [B, S, IN] (CUDA) from ``packed``, with
    an optional key mask [B, S] (nonzero = valid); returns [B, S, OUT] in
    the packed compute dtype.  Not differentiable: with grad on and an
    ``x`` that needs one it raises, since the result would carry no graph
    (``FusedSetTransformer`` is the differentiable form)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_set_transformer drops the autograd graph: "
                           "use FusedSetTransformer.apply for training")
    return _forward_launch(packed, x, num_heads, mask=mask)


def fused_set_transformer_bwd(packed: PackedWeights, x, g, *,
                              num_heads: int, mask=None,
                              _global_h: bool = False):
    """Kernel #4: the cotangent ``g`` [B, S, OUT] of the net's output pulled
    back to x and the 12 weights, under the forward's key mask.
    Returns (dx in x's dtype, 12 fp32 weight gradients shaped as
    ``flatten_params``).  The matrices' gradients are rounded to the
    compute dtype, as the transpose of their cast.  ``_global_h`` takes the
    global layout where the shared one fits too (bf16: the residual copies
    in the workspace; fp32: all of ``FMA_WS_REGIONS``), at the shared
    layout's grid: a check that the two give the same bits, not an
    option."""
    _check_x(packed, x, num_heads, "backward", mask)
    bf16 = packed.dtype == torch.bfloat16
    B, S, in_dim = x.shape
    if tuple(g.shape) != (B, S, packed.out_dim) or g.device != x.device:
        raise ValueError(f"fused SetTransformer backward: g "
                         f"{tuple(g.shape)} on {g.device}, want "
                         f"{(B, S, packed.out_dim)} on {x.device}")
    H, L, RH, OUT = packed.hidden, packed.layers, packed.mlp, packed.out_dim
    big = not bf16 and S > MAX_SET
    net = (packed.dtype, S, in_dim, H, RH, OUT, num_heads, L)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, smem, in_global, grid = bwd_launch(
        *net, B * S, sms, _global_h,
        fma_max_clusters(x.device, S, in_dim, H, num_heads, L, RH, OUT)
        if big and bwd_fits(*net) and not _global_h else None)
    if smem > MAX_SMEM:
        raise ValueError(f"fused SetTransformer backward: a tile needs "
                         f"{smem} bytes of shared memory, over {MAX_SMEM}")
    x2 = x.detach().to(packed.dtype).contiguous()
    g2 = g.detach().to(packed.dtype).contiguous()
    sizes = [math.prod(shape) for shape in packed.shapes]
    total = sum(sizes)
    dx = torch.empty_like(x2)
    dw = torch.empty(total, dtype=torch.float32, device=x.device)
    # bf16's global layout: no per-block slices; its workspace holds the
    # copies of h, the stash, then the operand images of its weight
    # gradients (wgrad_tiles_bf16 sums them)
    part = (None if bf16 and in_global else
            torch.empty(grid, total, dtype=torch.float32, device=x.device))
    wshape = WgradShape(B * S, S, in_dim, H, L, RH, OUT)
    if not in_global:
        ws = None
    elif bf16:
        kept = (h_workspace_elems(tile, H, L, grid)
                + stash_workspace_elems(tile, H, L, RH, grid))
        ws = torch.empty(kept + wgrad_workspace_elems(wshape, tile),
                         dtype=torch.bfloat16, device=x.device)
    else:
        ws = torch.empty(fma_workspace_elems(in_global, tile, H, RH, L, grid),
                         dtype=torch.float32, device=x.device)
    km = key_mask_bytes(mask)
    source, name = (_BIG_BWD_ENTRY if big
                    else _WS_BWD_ENTRY if in_global and not bf16
                    else _BWD_ENTRY[packed.dtype])
    with torch.cuda.device(x.device):
        fn = (_fn(source, name, _MASKED_BWD_ARGS) if bf16
              else _fma_fn(source, name, _FMA_BWD_ARGS, x.device))
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x2.data_ptr(), _mask_ptr(km), g2.data_ptr(),
                 packed.bwd_w_ptrs if bf16 else packed.fma_w_ptrs,
                 packed.b_ptrs, dx.data_ptr(),
                 None if part is None else part.data_ptr(),
                 dw.data_ptr(), None if ws is None else ws.data_ptr(),
                 B * S, S, in_dim, H, num_heads, L, RH, OUT, grid,
                 int(_global_h), stream)
    build.check(err, name)
    if bf16 and in_global:
        wgrad_tiles_bf16(ws[kept:], wshape, tile, grid, dw)
    (CLUSTER_BWD_LAUNCHES if big else BWD_LAUNCHES)[_KEY[packed.dtype]] += 1
    if km is not None:
        MASKED_BWD_LAUNCHES[_KEY[packed.dtype]] += 1
    if in_global:
        GLOBAL_H_BWD_LAUNCHES[_KEY[packed.dtype]] += 1
    dws = tuple(t.view(shape) for t, shape in
                zip(dw.split(sizes), packed.shapes))
    return dx.to(x.dtype), dws


class FusedSetTransformer(torch.autograd.Function):
    """``apply(x, packed, num_heads, mask, *ws)``: the net's output from
    kernel #3 (in fp32 its FMA form, the arithmetic #4 recomputes), and from
    kernel #4 in backward dx (x's dtype) and the fp32 gradients of the
    12-tuple ``ws`` (``flatten_params``, differentiable through its stacks).
    ``mask`` is the key mask [B, S] or None, an input with no gradient.
    ``packed`` holds ``ws`` cast once; x and the mask are saved."""

    @staticmethod
    def forward(ctx, x, packed, num_heads, mask, *ws):
        ctx.packed, ctx.num_heads = packed, num_heads
        ctx.has_mask = mask is not None
        ctx.save_for_backward(x, *(() if mask is None else (mask,)))
        return _forward_launch(packed, x, num_heads, differentiable=True,
                               mask=mask)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        mask = rest[0] if ctx.has_mask else None
        dx, dws = fused_set_transformer_bwd(ctx.packed, x, g,
                                            num_heads=ctx.num_heads,
                                            mask=mask)
        return (dx, None, None, None, *dws)
