"""The key mask of the fused SetTransformer kernels (#3 bf16, #4 bf16, #3
fp32, and the fp32 train step's FMA pair), on the CPU: the kernels' plain
version with a mask against the reference's masked ``apply`` (and, in
fp32, its gradients against ``jax.grad`` of it), the wrappers' mask
handling and argument order against the entry points' signatures (read
from the ``.cu`` sources), the tile shapes at GraphCNF's node sets, and
the backward's check at width 256.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.

Tolerances: fp32 within ``TOL`` = 1e-4, as the graph-coloring slice's
test (gradients within ``TOL`` of their largest magnitude); bf16 within 2
bf16 ulps at the output's scale, as the RGCN's test.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.networks.transformer import \
    SetTransformer as JaxSetTransformer
from categoricalnf_tpu_torch.convert import flatten_tree
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16


def _masks(b, s, seed):
    """[b, s] node masks of random sizes, set 0 with one valid key and set
    1 with none."""
    r = np.random.default_rng(seed)
    m = (np.arange(s)[None] < r.integers(1, s + 1, (b, 1))).astype(
        np.float32)
    m[0] = 0.0
    m[0, 0] = 1.0
    m[1] = 0.0
    return m


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [6, 24])
def test_masked_plain_forward_matches_reference(s, cd):
    """plain_forward with a key mask on the reference's weights (output
    layer random) against the reference's masked apply, the set with no
    valid key included (it attends uniformly, in both)."""
    r = np.random.default_rng(s)
    j = JaxSetTransformer(hidden_dim=16, num_heads=4, num_layers=2,
                          compute_dtype=cd)
    params = jax.tree.map(np.asarray, j.init(jax.random.PRNGKey(s), 3, 10))
    params["out"]["w"] = (r.standard_normal(params["out"]["w"].shape)
                          * 0.3).astype(np.float32)
    net = SetTransformer(3, 10, hidden_dim=16, num_heads=4, compute_dtype=cd)
    net.load_state_dict(flatten_tree(params))
    x = r.standard_normal((4, s, 3)).astype(np.float32)
    mask = _masks(4, s, s)
    want = np.asarray(j.apply(params, jnp.asarray(x),
                              mask=jnp.asarray(mask))).astype(np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x), mask=torch.tensor(mask)).float().numpy()
        unmasked = net(torch.tensor(x)).float().numpy()
    tol = TOL if cd == "float32" else 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the mask matters: the unmasked net reads far from it
    assert np.abs(unmasked - want).max() > 10 * tol


def _masked_fp32_gradients_against_jax(hidden, s, b, out, seed):
    """The output and the gradients of x and of every parameter of an fp32
    net (4 heads, 2 blocks, in 3) on ``b`` sets of ``s`` under a ragged
    mask (a set of one valid key and one of none) through the port's plain
    path (autograd, the plain version of the FMA pair) against
    ``jax.grad`` of the reference's masked ``apply`` for the same
    cotangent, the weights carried across by ``convert.flatten_tree``:
    each within TOL of its largest magnitude; and the call without the
    mask far from them."""
    r = np.random.default_rng(seed)
    j = JaxSetTransformer(hidden_dim=hidden, num_heads=4, num_layers=2,
                          compute_dtype="float32")
    params = jax.tree.map(np.asarray, j.init(jax.random.PRNGKey(seed), 3,
                                             out))
    params["out"]["w"] = (r.standard_normal(params["out"]["w"].shape)
                          * 0.3).astype(np.float32)
    x = r.standard_normal((b, s, 3)).astype(np.float32)
    g = r.standard_normal((b, s, out)).astype(np.float32)
    mask = _masks(b, s, seed + 1)

    def loss(p, xx):
        return jnp.sum(j.apply(p, xx, mask=jnp.asarray(mask)) * g)

    want_y = np.asarray(j.apply(params, jnp.asarray(x),
                                mask=jnp.asarray(mask)))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in flatten_tree(gp).items()}
    net = SetTransformer(3, out, hidden_dim=hidden, num_heads=4,
                         compute_dtype="float32")
    net.load_state_dict(flatten_tree(params))
    xt = torch.tensor(x, requires_grad=True)
    y = net(xt, mask=torch.tensor(mask))
    names, params_t = zip(*net.named_parameters())
    grads = torch.autograd.grad(y, [xt, *params_t], torch.tensor(g))

    def near(a, b):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=TOL * max(np.abs(b).max(), 1.0))

    near(y.detach().numpy(), want_y)
    near(grads[0].numpy(), np.asarray(gx))
    assert set(names) == set(want)
    for name, got in zip(names, grads[1:]):
        near(got.numpy(), want[name].reshape(got.shape))
    # the mask matters to the gradients too
    y_u = net(xt)
    gx_u = torch.autograd.grad(y_u, xt, torch.tensor(g))[0]
    assert np.abs(gx_u.numpy() - np.asarray(gx)).max() > 10 * TOL


def test_masked_fp32_gradients_match_jax_grad():
    """In fp32, at sets of 6, hidden 16 and a ragged mask, the port's plain
    path's output and gradients against ``jax.grad`` of the reference
    (``_masked_fp32_gradients_against_jax``)."""
    _masked_fp32_gradients_against_jax(16, 6, 5, 10, 11)


@pytest.mark.parametrize("hidden,out", [(192, 6 * 26), (256, 6 * 50)])
def test_masked_fp32_gradients_match_jax_grad_at_node_flow_widths(hidden,
                                                                   out):
    """The same at the widths whose backward keeps regions of its tile in
    global memory on the card (molecules_v3/_v4 at 192, K = 8; moses and
    molecules_v5-v7 at 256, K = 16), on 3 graphs of GraphCNF's 24 nodes:
    the kernel's yardstick held against the reference there."""
    _masked_fp32_gradients_against_jax(hidden, 24, 3, out, hidden)


def test_masked_keys_do_not_reach_valid_rows():
    """Valid rows do not depend on the masked keys' inputs (their
    probability is exactly 0); a mask of ones is the call without a mask,
    bitwise."""
    net = SetTransformer(3, 10, hidden_dim=16, num_heads=4,
                         compute_dtype="float32",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.out.w.normal_(generator=torch.Generator().manual_seed(1))
        x = torch.randn(4, 6, 3, generator=torch.Generator().manual_seed(2))
        mask = torch.tensor(_masks(4, 6, 3))
        y = net(x, mask=mask)
        x2 = x + 5.0 * (1.0 - mask)[..., None]
        y2 = net(x2, mask=mask)
        valid = mask > 0
        assert torch.equal(y[valid], y2[valid])
        assert not torch.equal(y[~valid], y2[~valid])
        assert torch.equal(net(x, mask=torch.ones(4, 6)), net(x))


def test_key_mask_bytes():
    m = torch.tensor([[1.0, 0.0, 0.5], [0.0, 0.0, 2.0]])
    km = ft.key_mask_bytes(m)
    assert km.dtype == torch.uint8 and km.is_contiguous()
    assert km.tolist() == [[1, 0, 1], [0, 0, 1]]
    assert ft.key_mask_bytes(m.bool().t().contiguous().t()).tolist() == \
        km.tolist()
    assert ft.key_mask_bytes(None) is None


@pytest.mark.parametrize("mask_shape,ok", [((2, 24), True), ((2, 23), False),
                                           ((1, 24), False),
                                           ((2, 24, 1), False)])
def test_supported_takes_a_key_mask_of_the_sets_shape(mask_shape, ok):
    x = torch.zeros(2, 24, 6)
    for cd in (BF16, torch.float32):
        assert ft.supported(x, None, torch.ones(mask_shape), 192, 4,
                            compute_dtype=cd) == ok
    assert not ft.supported(x, torch.ones(2, 24, 1), None, 192, 4)


_CTYPES = {"const void*": ft._P, "void*": ft._P, "const void* const*": ft._P,
           "const float* const*": ft._P, "float*": ft._P, "long": ft._L,
           "int": ft._I}


def _signature(source: str, entry: str) -> list:
    """(type, name) of each parameter of ``entry`` in ``source``."""
    with open(os.path.join(REPO, source)) as f:
        text = f.read()
    m = re.search(rf"\bint {entry}\((.*?)\)\s*\{{", text, re.S)
    assert m, entry
    out = []
    for p in " ".join(m.group(1).split()).split(","):
        typ, name = p.strip().rsplit(" ", 1)
        while name.startswith("*"):
            typ, name = typ + "*", name[1:]
        out.append((typ.replace(" *", "*"), name))
    return out


@pytest.mark.parametrize("source,entry,args,mask_at", [
    ("categoricalnf_tpu_torch/csrc/fused_transformer_bf16.cu",
     "fused_set_transformer_fwd_bf16", "_MASKED_FWD_ARGS", 1),
    ("categoricalnf_tpu_torch/csrc/fused_transformer_bf16.cu",
     "fused_set_transformer_bwd_bf16", "_MASKED_BWD_ARGS", 1),
    ("categoricalnf_tpu_torch/csrc/fused_transformer_tf32x3.cu",
     "fused_set_transformer_fwd_f32", "_MASKED_FWD_ARGS", 1),
    ("categoricalnf_tpu_torch/csrc/fused_transformer.cu",
     "fused_set_transformer_train_fwd_f32", "_MASKED_FWD_ARGS", 1),
    ("categoricalnf_tpu_torch/csrc/fused_transformer.cu",
     "fused_set_transformer_bwd_f32", "_FMA_BWD_ARGS", 1),
    ("categoricalnf_tpu_torch/csrc/fused_transformer_f32_ws.cu",
     "fused_set_transformer_bwd_f32_ws", "_FMA_BWD_ARGS", 1),
    ("categoricalnf_tpu_torch/csrc/fused_transformer_f32_big.cu",
     "fused_set_transformer_train_fwd_f32_big", "_MASKED_FWD_ARGS", 1),
    ("categoricalnf_tpu_torch/csrc/fused_transformer_f32_big.cu",
     "fused_set_transformer_bwd_f32_big", "_FMA_BWD_ARGS", 1),
    ("tools/f32_bwd_tf32x3.cu", "fused_set_transformer_bwd_f32_tf32x3",
     "_BWD_ARGS", None)])
def test_wrapper_argument_order_matches_the_entry_points(source, entry, args,
                                                         mask_at):
    """Each entry point's C signature against the ctypes list its wrapper
    calls it with: the same count and types, the key mask (where taken:
    every kernel of the port, the fp32 FMA pair too) the pointer after
    x's, and none in the 3xTF32 #4 that waits in tools/; each backward's
    workspace after dw and its layout switch after grid."""
    sig = _signature(source, entry)
    assert [_CTYPES[t] for t, _ in sig] == getattr(ft, args)
    names = [n for _, n in sig]
    assert names[0] == "x" and names[-1] == "stream"
    if mask_at is None:
        assert "key_mask" not in names
    else:
        assert names.index("key_mask") == mask_at
    if "bwd" in entry and mask_at is not None:
        # both backwards: the global workspace after dw, the switch that
        # forces the global layout after grid
        assert names[7:9] == ["dw", "hws" if "bf16" in entry else "ws"]
        assert names[-3:-1] == ["grid", "global_h" if "bf16" in entry
                                else "global_ws"]


# (hidden, out) of the node flow's nets at its sets of 24 nodes, in 6 -> the
# tile and shared memory of #3 bf16, #4 bf16, #3 fp32 and the fp32 FMA #4,
# as the kernels pick them (a shared-memory limit of 232,448 B); #4 bf16 at
# 256 with its residual copies in global memory (252,928 B with them in
# shared memory); the FMA #4 at 24 (padded to 24) rows of (2 + 6) [24, 100]
# buffers, qkv [24, 292], the MLP pair [24, 2 x 196] and the statistics at
# 96, with its warps' weight rings (12,288 B), and the regions it keeps in
# global memory: none to 128; at 192 the residual copies and the MLP pair
# (281,856 B all shared, 244,224 B with the copies alone out), at 256 qkv
# too (374,016 B all shared; 299,136 B with the copies and the pair out),
# without the rings
NODE_FLOW_TILES = {
    96: ((48, 48_384), (48, 148_992), (24, 47_264), (24, 155_904, ())),
    128: ((48, 63_744), (48, 195_072), (24, 62_624), (24, 201_984, ())),
    192: ((48, 94_464), (24, 191_488), (24, 93_344),
          (24, 225_408, ("copies", "mlp"))),
    256: ((48, 125_184), (24, 219_136), (24, 124_064),
          (24, 225_024, ("copies", "mlp", "qkv")))}


@pytest.mark.parametrize("hidden", sorted(NODE_FLOW_TILES))
def test_node_flow_tiles(hidden):
    fwd, bwd, f32, fma_bwd = NODE_FLOW_TILES[hidden]
    out = 6 * (2 + 3 * 8)
    assert ft.fwd_shape(BF16, 24, 6, hidden, 2 * hidden)[:2] == fwd
    assert ft.bwd_layout(BF16, 24, 6, hidden, 2 * hidden, out, 4, 2) == (
        *bwd, hidden == 256, 1)
    assert ft.fwd_shape(torch.float32, 24, 6, hidden, 2 * hidden)[:2] == f32
    assert ft.bwd_fits(BF16, 24, 6, hidden, 2 * hidden, out, 4, 2)
    assert ft.supported(torch.zeros(2, 24, 6), None, torch.ones(2, 24),
                        hidden, 4, compute_dtype=BF16)
    # the fp32 train step's pair: its backward's tile fits at every width
    # of the node flow, from 192 with regions in global memory, and a
    # differentiable fp32 call passes the check before its launch
    F32 = torch.float32
    assert ft.bwd_layout(F32, 24, 6, hidden, 2 * hidden, out, 4,
                         2)[:3] == fma_bwd
    assert fma_bwd[1] <= ft.MAX_SMEM
    assert ft.bwd_fits(F32, 24, 6, hidden, 2 * hidden, out, 4, 2)
    assert bool(fma_bwd[2]) == (hidden >= 192)
    net = SetTransformer(6, out, hidden_dim=hidden, num_heads=4,
                         compute_dtype="float32")
    net.check_backward_fits(torch.zeros(2, 24, 6))


def _fma_bwd_bytes(s, in_dim, hidden, out, regions, layers=2, heads=4):
    """The FMA #4's shared-memory buffers (no rings) with ``regions`` in
    global memory, written out from the kernel's layout: the residual
    copies (L + 1, or one), five [tile, H] buffers, qkv unless it moved,
    r2 (the MLP pair unless it moved; the qkv gradient, g, x) and the
    statistics, every row conflict_free wide but x's."""
    cf = ft.conflict_free
    tile_pad = -(-max(1, 32 // s) * s // 8) * 8
    copies = 1 if "copies" in regions else layers + 1
    r2 = max(cf(3 * hidden), cf(out), ft.pad4(in_dim),
             0 if "mlp" in regions else 2 * cf(2 * hidden))
    qkv = 0 if "qkv" in regions else cf(3 * hidden)
    return 4 * tile_pad * ((copies + 5) * cf(hidden) + qkv + r2 + 3 * heads)


# (sets, in, hidden, out, rows) -> regions in global memory and grid on an
# H100's 132 SMs: the flagship (its check's 4,096 rows and a batch's
# 16,384), runs/molecules and molecules_long/_v2 keep the shared layout and
# its grid; molecules_v3/_v4 (192, K = 8) move the copies and the MLP pair,
# moses and molecules_v5-v7 (256, K = 16) qkv too
FMA_LAYOUTS = [
    ((16, 4, 96, 104, 4_096), (), 128),
    ((16, 4, 96, 104, 16_384), (), 132),
    ((24, 6, 96, 156, 1_536), (), 64),
    ((24, 6, 128, 156, 3_072), (), 128),
    ((24, 6, 192, 156, 3_072), ("copies", "mlp"), 128),
    ((24, 6, 256, 300, 4_608), ("copies", "mlp", "qkv"), 132)]


@pytest.mark.parametrize("net,regions,grid", FMA_LAYOUTS)
def test_fma_bwd_layout_rule(net, regions, grid):
    """The FMA #4's layout rule (``bwd_layout``, the kernel's
    ``pick_bwd_regions``): the regions move to global memory in the order
    of FMA_WS_REGIONS and only as far as the tile needs, each layout's
    bytes as the kernel lays them out, the weight rings where they fit;
    the grid one block an SM up to the tiles; a layout forced global
    (``_global_h``, the bitwise check) moves all three at the default
    layout's grid; the workspace as the per-block sum of the regions."""
    s, in_dim, hidden, out, rows = net
    F32 = torch.float32
    shape = (F32, s, in_dim, hidden, 2 * hidden, out, 4, 2)
    tile, smem, got, _ = ft.bwd_layout(*shape)
    assert got == regions == ft.FMA_WS_REGIONS[:len(regions)]
    need = _fma_bwd_bytes(s, in_dim, hidden, out, regions)
    assert smem == ft.with_rings(need) <= ft.MAX_SMEM
    assert (smem > need) == (need + ft.FMA_RING_BYTES <= ft.MAX_SMEM)
    if regions:  # one region fewer does not fit
        assert _fma_bwd_bytes(s, in_dim, hidden, out,
                              regions[:-1]) > ft.MAX_SMEM
    assert ft.bwd_launch(*shape, rows, 132) == (tile, smem, regions, grid)
    forced = ft.bwd_launch(*shape, rows, 132, True)
    assert forced[0] == tile and forced[3] == grid
    assert forced[2] == ft.FMA_WS_REGIONS
    assert forced[1] == ft.with_rings(_fma_bwd_bytes(
        s, in_dim, hidden, out, ft.FMA_WS_REGIONS))
    tile_pad = -(-tile // 8) * 8
    per_block = tile_pad * (
        ("copies" in regions) * 2 * ft.conflict_free(hidden)
        + ("mlp" in regions) * 2 * ft.conflict_free(2 * hidden)
        + ("qkv" in regions) * ft.conflict_free(3 * hidden))
    assert ft.fma_workspace_elems(regions, tile, hidden, 2 * hidden, 2,
                                  grid) == grid * per_block


def test_fma_workspace_bytes_at_the_node_flow():
    """The FMA #4's workspace at molecules_v4's and moses's node flows:
    112,128 B a block at hidden 192 (the copies [2, 24, 196] and the MLP
    pair [2, 24, 388]), 14.4 MB at grid 128; 223,104 B at 256 (qkv [24,
    772] too), 29.4 MB at grid 132: inside the H100's 50 MB of L2."""
    assert ft.fma_workspace_elems(("copies", "mlp"), 24, 192, 384, 2,
                                  1) * 4 == 112_128
    assert ft.fma_workspace_elems(ft.FMA_WS_REGIONS, 24, 256, 512, 2,
                                  1) * 4 == 223_104
    assert ft.fma_workspace_elems(("copies", "mlp"), 24, 192, 384, 2,
                                  128) * 4 == 14_352_384
    assert ft.fma_workspace_elems(ft.FMA_WS_REGIONS, 24, 256, 512, 2,
                                  132) * 4 == 29_449_728
    assert ft.fma_workspace_elems((), 24, 96, 192, 2, 64) == 0


@pytest.mark.parametrize("hidden,mlp_ratio,k", [(272, 2, 8), (320, 2, 16),
                                                (384, 4, 16)])
def test_fp32_training_over_shared_memory_is_refused_before_launch(
        hidden, mlp_ratio, k):
    """An fp32 tile over the shared memory even with every region in
    global memory (widths above 264 at sets of 24, whatever the MLP ratio:
    the MLP pair has moved) is refused before the forward launches, naming
    the ROADMAP item: Queue C, a call the kernels refuse.  The check reads
    only shapes."""
    out = 6 * (2 + 3 * k)
    net = SetTransformer(6, out, hidden_dim=hidden, num_heads=4,
                         mlp_ratio=mlp_ratio, compute_dtype="float32")
    tile, smem, regions, _ = ft.bwd_layout(torch.float32, 24, 6, hidden,
                                           mlp_ratio * hidden, out, 4, 2)
    assert regions == ft.FMA_WS_REGIONS and smem > ft.MAX_SMEM
    assert not ft.bwd_fits(torch.float32, 24, 6, hidden, mlp_ratio * hidden,
                           out, 4, 2)
    with pytest.raises(NotImplementedError, match="Queue C"):
        net.check_backward_fits(torch.zeros(2, 24, 6))
    assert net._packed is None
    # the forward takes it
    assert ft.supported(torch.zeros(2, 24, 6), None, torch.ones(2, 24),
                        hidden, 4, mlp_ratio)


@pytest.mark.parametrize("s,in_dim,hidden,out,want", [
    (16, 4, 96, 104, (32, 75_264)),   # the flagship
    (16, 1, 96, 26, (32, 75_264)),    # the vardeq main flow
    (24, 6, 96, 156, (24, 59_520)),   # runs/molecules' node flow
    (24, 6, 128, 156, (24, 74_880)),  # molecules_long, _v2
    (5, 3, 18, 7, (30, 4 * 32 * (2 * 20 + 60) + 12_288))])
def test_fma_forward_shape(s, in_dim, hidden, out, want):
    """The fp32 FMA forward's tile and shared memory (``fma_fwd_shape``):
    whole sets up to 32 rows padded to 8, h and the LN/attention output
    [tile, conflict_free(H)] and the widest of qkv, the MLP hidden layer
    and x, every row 4 mod 8 floats wide but x's; and the 8 warps' weight
    rings, 4 steps of 4 rows of 6 column groups of 16 bytes each."""
    tile, smem, cluster = ft.fma_fwd_shape(s, in_dim, hidden, 2 * hidden)
    assert (tile, smem) == want and tile % s == 0 and cluster == 1
    pad = -(-tile // 8) * 8
    big = max(ft.conflict_free(3 * hidden), ft.conflict_free(2 * hidden),
              ft.pad4(in_dim))
    assert ft.FMA_RING_BYTES == 8 * 4 * 4 * 6 * 16 == 12_288
    assert smem == 4 * pad * (2 * ft.conflict_free(hidden) + big) + 12_288
    assert ft.conflict_free(hidden) % 8 == 4 and big % 4 == 0
    assert smem <= ft.MAX_SMEM
    # the rings are left out where they would not fit beside the buffers
    assert ft.with_rings(ft.MAX_SMEM - 12_287) == ft.MAX_SMEM - 12_287
    assert ft.with_rings(ft.MAX_SMEM - 12_288) == ft.MAX_SMEM


@pytest.mark.parametrize("hidden,k", [(256, 8), (256, 16), (192, 8)])
def test_width_256_bf16_training_is_refused_before_launch(hidden, k):
    """The nets of the configs (MLP ratio 2) pass the backward's check at
    width 256, whose tile then keeps the residual copies in global memory
    (a [24 -> 32, 264] bf16 image for each of the 2 block boundaries a
    block), and at 192 with them in shared memory; a differentiable bf16
    call is refused before its forward launches only where the tile is
    over the shared memory even so (an MLP ratio of 4 at width 256),
    naming the ROADMAP item.  The check reads only shapes, so it runs here
    on CPU tensors."""
    out = 6 * (2 + 3 * k)
    net = SetTransformer(6, out, hidden_dim=hidden, num_heads=4,
                         compute_dtype="bfloat16")
    x = torch.zeros(2, 24, 6)
    net.check_backward_fits(x)
    tile, smem, in_global, _ = ft.bwd_layout(BF16, 24, 6, hidden,
                                             2 * hidden, out, 4, 2)
    assert tile == 24 and smem <= ft.MAX_SMEM
    assert in_global == (hidden == 256)
    if in_global:
        assert smem == 2 * 32 * (6 * 264 + 776 + 1040) + 4 * 32 * 3 * 4
        assert ft.h_workspace_elems(tile, hidden, 2, 132) == (
            132 * 2 * 32 * 264)
    wide = SetTransformer(6, out, hidden_dim=hidden, num_heads=4,
                          mlp_ratio=4, compute_dtype="bfloat16")
    if hidden < 256:
        wide.check_backward_fits(x)
        return
    with pytest.raises(NotImplementedError, match="Queue C"):
        wide.check_backward_fits(x)
    assert wide._packed is None
    # the forward takes it
    assert ft.supported(x, None, torch.ones(2, 24), hidden, 4, 4,
                        compute_dtype=BF16)
