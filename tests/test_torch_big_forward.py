"""#3's attention at sets of 33 to 128 rows on warp tiles, on the CPU.

#3 (the fused SetTransformer forward) runs its attention at sets above 32
as #4's recompute does (``csrc/fused_transformer_bf16.cu``
``attention_mma_big`` on the tensor cores,
``csrc/fused_transformer_tiles.cuh`` ``attention_tiled_big`` on register
tiles for the fp32 train step's forward): a warp a 16-row tile of one
head's queries against every key of the set at once, without the row
statistics that #4 keeps; in bf16 above 64 rows with a warp's logits in
two halves of the keys, the row's max and sum taken under a running max
(``attention_mma_halves``).  The 3xTF32 eval twin (#3 fp32 without grad,
``csrc/fused_transformer_tf32x3.cu`` ``attention_warp_tiles``) takes the
same warp tiles on the tensor cores with its products in 3xTF32: QK^T and
P.V each a_lo.b_hi + a_hi.b_lo + a_hi.b_hi of the operands' TF32 parts
(``mirror_twin``).  The set is split the way #3's own layout splits it:
``fwd_shape``'s cluster in bf16 (one block up to 64 rows at these widths,
two above), ``fma_fwd_shape``'s in fp32 with grad and ``fwd_shape``'s for
the twin (both two blocks up to 64 rows, four above).  The kernels run on the
card only (``tests/test_torch_cuda.py``); here the numpy mirror of that
tile schedule and its rounding points (``tests/test_torch_big_attention.py``
``mirror_forward``, ``tiles``; ``mirror_halves`` here) replaces the
attention of the port's plain
path, and the net's output is held against the reference's fused kernel in
interpret mode: its Pallas call at sets of 64 and 128, its kernel body
``_net_forward`` on a tile of whole sets at 48 and 100 (which its tiles do
not take), and with a key mask at 64 its masked ``apply``.

Also here: the bf16 forward's layout at these sets (the staged copy of the
other block's K and V in the region of the attention output) and the
blocks an SM that the ``BIG`` instances' launch bounds give.

Tolerances: fp32 within TOL = 1e-4 of the reference's largest magnitude,
bf16 within 0.03 relative norm (those of ``test_torch_big_attention.py``);
the twin also within F32_FWD_REL = 1e-5 of the reference's norm (its limit
against ``plain_forward`` in ``chip_smoke.py``).
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.ops.pallas import fused_transformer as jft
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.networks.common import layer_norm
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "categoricalnf_tpu_torch", "csrc")


def _mirror_module():
    spec = importlib.util.spec_from_file_location(
        "big_attention_mirror", os.path.join(HERE,
                                             "test_torch_big_attention.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bam = _mirror_module()
HIDDEN, HEADS, IN, OUT, LAYERS = bam.HIDDEN, bam.HEADS, bam.IN, bam.OUT, \
    bam.LAYERS
F32 = np.float32
F32_FWD_REL = 1e-5


def fwd_cluster(cd: str, s: int) -> int:
    """Blocks a set of ``s`` spans in #3 of ``cd`` (``tf32x3``: the fp32
    twin) at the test's width."""
    if cd == "bfloat16":
        return ft.fwd_shape(torch.bfloat16, s, IN, HIDDEN, 2 * HIDDEN)[2]
    if cd == "tf32x3":
        return ft.fwd_shape(torch.float32, s, IN, HIDDEN, 2 * HIDDEN,
                            HEADS)[2]
    return ft.fma_fwd_shape(s, IN, HIDDEN, 2 * HIDDEN)[2]


def rna(x):
    """fp32 to TF32, to nearest with ties away (``cvt.rna.tf32.f32``)."""
    u = np.asarray(x, F32).view(np.int32)
    return ((u + np.int32(0x1000)) & np.int32(-0x2000)).view(F32)


def mm3(a, b):
    """a @ b in 3xTF32 as the twin's warp tiles take it: a_lo.b_hi +
    a_hi.b_lo, then a_hi.b_hi added (TF32 parts, exact products, fp32
    sums)."""
    a_hi, b_hi = rna(a), rna(b)
    a_lo, b_lo = rna(a - a_hi), rna(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mirror_twin(q, k, v, masked, cluster):
    """The twin's attention of one set and head (q, k, v [S, hd] fp32):
    each warp tile's logits in 3xTF32, scaled by 1 / sqrt(hd), masked keys
    -1e9, the softmax in fp32, P.V in 3xTF32; up to 64 rows the logits
    against the whole set at once, above in two halves of the keys, the
    row's max and sum under a running max and P.V of the second half added
    to the first's."""
    S, hd = q.shape
    inv_root = F32(1) / np.sqrt(F32(hd))
    out = np.zeros_like(q)
    for r0, r1 in bam.tiles(S, cluster):
        l = mm3(q[r0:r1], k.T) * inv_root
        l[:, masked] = F32(-1e9)
        halves = (slice(0, 64), slice(64, S)) if S > 64 else (slice(0, S),)
        m = l[:, halves[0]].max(1)
        s = np.exp(l[:, halves[0]] - m[:, None]).sum(1, dtype=F32)
        for h in halves[1:]:
            m1 = np.maximum(m, l[:, h].max(1))
            s = (s * np.exp(m - m1)
                 + np.exp(l[:, h] - m1[:, None]).sum(1, dtype=F32))
            m = m1
        p = np.exp(l - m[:, None]) * (F32(1) / s)[:, None]
        out[r0:r1] = sum(mm3(p[:, h], v[h]) for h in halves)
    return out


def mirror_halves(q, k, v, masked, cluster):
    """#3 bf16's attention of one set and head above 64 rows (q, k, v [S,
    hd], bf16 values in fp32): each tile's logits in two halves of the
    keys, the row's max and sum under a running max, then p from the final
    ones, rounded to bf16 before A.V, the output rounded once."""
    S, hd = q.shape
    inv_root = F32(1) / np.sqrt(F32(hd))
    out = np.zeros_like(q)
    for r0, r1 in bam.tiles(S, cluster):
        l = bam.logits(q[r0:r1], k, inv_root, masked)
        m0 = l[:, :64].max(1)
        s0 = np.exp(l[:, :64] - m0[:, None]).sum(1, dtype=F32)
        m = np.maximum(m0, l[:, 64:].max(1))
        s = (s0 * np.exp(m0 - m)
             + np.exp(l[:, 64:] - m[:, None]).sum(1, dtype=F32))
        p = np.exp(l - m[:, None]) * (F32(1) / s)[:, None]
        out[r0:r1] = bam.rnd(bam.rnd(p) @ v)
    return out


def mirror_forward_attention(cluster, twin=False):
    """A stand-in for ``SetTransformer._attention``: #3's attention of each
    set and head by the mirror (``twin``: ``mirror_twin``), split over
    ``cluster`` blocks."""
    def attention(self, blk, h, mask, cd):
        B, T, H = h.shape
        nh, hd = self.num_heads, H // self.num_heads
        qkv = blk.qkv(layer_norm(h), cd).reshape(B, T, 3, nh, hd)
        bf16 = qkv.dtype == torch.bfloat16
        q, k, v = (qkv[:, :, i].transpose(1, 2).float().numpy()
                   for i in range(3))
        km = (np.zeros((B, T), bool) if mask is None
              else ~mask.bool().numpy())
        out = np.zeros_like(q)
        for b in range(B):
            for hh in range(nh):
                if twin:
                    out[b, hh] = mirror_twin(q[b, hh], k[b, hh], v[b, hh],
                                             km[b], cluster)
                elif bf16 and T > 64:
                    out[b, hh] = mirror_halves(q[b, hh], k[b, hh], v[b, hh],
                                               km[b], cluster)
                else:
                    out[b, hh] = bam.mirror_forward(
                        q[b, hh], k[b, hh], v[b, hh], km[b], bf16,
                        cluster)[0]
        o = torch.from_numpy(out).to(qkv.dtype).transpose(1, 2)
        return blk.proj(o.reshape(B, T, H), cd)
    return attention


def _reference_forward(j, params, x, s, cd, mask):
    """The reference's output: its fused kernel at 64 and 128, its kernel
    body on one tile of whole sets at the other sizes, its masked apply
    with a mask."""
    if mask is not None:
        def fn(p, xx):
            return j.apply(p, xx, mask=jnp.asarray(mask))
    elif jft.supported(jnp.zeros(x.shape), None, None, HIDDEN, HEADS):
        def fn(p, xx):
            return jft.fused_set_transformer(
                p, xx, hidden_dim=HIDDEN, num_heads=HEADS,
                num_layers=LAYERS, mlp_ratio=j.mlp_ratio, compute_dtype=cd,
                out_dim=OUT)
    else:
        cfg = jft.FusedCfg(HIDDEN, HEADS, LAYERS, j.mlp_ratio, cd, OUT, s)

        def fn(p, xx):
            b = xx.shape[0]
            return jft._net_forward(
                xx.reshape(b * s, IN).astype(cd),
                jft.flatten_params(p, LAYERS), cfg).reshape(b, s, OUT)

    y = jax.jit(lambda p, xx: fn(p, xx).astype(jnp.float32))(
        params, jnp.asarray(x))
    return np.asarray(y)


CASES = [(s, cd, False) for s in (48, 64, 100, 128)
         for cd in ("float32", "bfloat16", "tf32x3")] + [
    (64, cd, True) for cd in ("float32", "bfloat16", "tf32x3")]


@pytest.mark.parametrize("s,cd,masked", CASES)
def test_forward_tile_schedule_matches_the_reference(s, cd, masked,
                                                     monkeypatch):
    """The port's net with the mirror of #3's warp-tile attention (the set
    split over the cluster that #3 takes at this width; ``tf32x3``: the
    fp32 twin's, in fp32) against the reference's forward on 2 sets (with
    a key mask: set 0 one valid key, set 1 a ragged prefix)."""
    twin = cd == "tf32x3"
    cluster = fwd_cluster(cd, s)
    if twin:
        cd = "float32"
    j, params, net = bam._nets(s, s + masked, cd)
    r = np.random.default_rng(s + 3)
    x = r.standard_normal((2, s, IN)).astype(F32)
    mask = None
    if masked:
        mask = np.zeros((2, s), F32)
        mask[0, 0] = 1
        mask[1, :s // 3] = 1
    want = _reference_forward(j, params, x, s, cd, mask)
    monkeypatch.setattr(SetTransformer, "_attention",
                        mirror_forward_attention(cluster, twin))
    with torch.no_grad():
        y = net(torch.tensor(x),
                mask=None if mask is None else torch.tensor(mask))
    got = y.float().numpy()
    bam._close(got, want, cd == "bfloat16", "y")
    if twin:
        assert np.linalg.norm(got - want) <= F32_FWD_REL * np.linalg.norm(
            want)


@pytest.mark.parametrize("s,clusters", [(33, (1, 2)), (64, (1, 2)),
                                        (65, (2, 4)), (100, (2, 4)),
                                        (128, (2, 4))])
def test_forward_splits_a_set_as_its_layout_says(s, clusters):
    """#3 bf16 holds a set of up to 64 rows in one block at the flagship's
    and the test's width and spans two blocks above; #3 fp32 with grad
    spans two up to 64 rows and four above (``fma_tile``), and so does the
    fp32 twin; the mirror's tiles cover each block's rows once, none
    across a block."""
    assert (fwd_cluster("bfloat16", s), fwd_cluster("float32", s)) == \
        clusters
    assert fwd_cluster("tf32x3", s) == clusters[1]
    assert ft.fwd_shape(torch.bfloat16, s, 4, 96, 192)[2] == clusters[0]
    assert ft.fwd_shape(torch.float32, s, 4, 96, 192, 4)[2] == clusters[1]
    for cluster in clusters:
        split = -(-s // cluster)
        seen = []
        for r0, r1 in bam.tiles(s, cluster):
            assert r0 // split == (r1 - 1) // split and r1 - r0 <= 16
            seen += range(r0, r1)
        assert seen == list(range(s))


@pytest.mark.parametrize("hidden", [16, 96, 256])
@pytest.mark.parametrize("s", [33, 48, 64, 65, 99, 100, 128])
def test_bf16_forward_layout_holds_the_staged_rows(hidden, s):
    """Over a cluster, #3 bf16 copies the other block's K and V (split
    rows, ``pad16(2 hidden) + 8`` wide: ``bf16_big_stage``'s bytes) into
    the region of its attention output, whose rows' output goes over their
    Q meanwhile; that region is the larger of the copy and a [tile_pad,
    ld_h] buffer.  So the layout fits at every set and width up to 256,
    where a region of the copy's own beside the three buffers would not
    (233,472 B at hidden 256 and a set of 128)."""
    tile, smem, cluster = ft.fwd_shape(torch.bfloat16, s, 4, hidden,
                                       2 * hidden)
    tp, ld_h = ft.pad16(tile), ft.pad16(hidden) + 8
    ld_big = ft.pad16(3 * hidden) + 8
    stage = ft.bf16_big_stage(s, hidden, cluster)[0]
    assert (stage > 0) == (cluster > 1)
    if cluster > 1:
        assert stage == 2 * ft.split_rows(s, cluster) * (
            ft.pad16(2 * hidden) + 8)
    assert smem == 2 * tp * (ld_h + ld_big) + max(2 * tp * ld_h, stage)
    assert smem <= ft.MAX_SMEM
    if (hidden, s) == (96, 128):
        assert smem == 51_200 + 25_600 == 76_800
    if (hidden, s) == (256, 128):
        assert smem == 199_680
        assert 2 * tp * (2 * ld_h + ld_big) + stage > ft.MAX_SMEM


def _launch_bounds(source: str) -> int:
    """The blocks an SM that the launch bounds of a source's forward kernel
    (one template, its BIG instance included) give registers for."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    found = re.findall(r"__launch_bounds__\(kThreads, (\w+)\)\n"
                       r"fused_set_transformer_fwd\(", text)
    assert len(found) == 1
    if found[0].isdigit():
        return int(found[0])
    return int(re.search(rf"constexpr int {found[0]} = (\d+);",
                         text).group(1))


def _twin_launch_bounds() -> tuple[int, int]:
    """The blocks an SM that the 3xTF32 forward's launch bounds give
    registers for: its instance for sets up to 32 and its BIG instance."""
    with open(os.path.join(CSRC, "fused_transformer_tf32x3.cu")) as f:
        text = f.read()
    assert len(re.findall(r"__launch_bounds__\(kThreads, BIG \? kBigBlocks "
                          r": kBlocks\)\nfused_set_transformer_fwd_tf32x3\(",
                          text)) == 1
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
                 for name in ("kBlocks", "kBigBlocks"))


@pytest.mark.parametrize("s", [16, 32, 33, 64, 100, 128])
def test_forward_blocks_an_sm_follow_the_launch_bounds(s):
    """``fwd_blocks_per_sm`` and FMA_FWD_BLOCKS give the blocks an SM that
    the forwards' launch bounds give registers for, read from the sources:
    two, the BIG instances too (their attention spills at 128 registers,
    yet ran faster at two blocks than at one, PERF.md), and shared memory
    holds at least that many at the flagship's width.  The fp32 twin's
    (F32_BLOCKS, F32_BIG_BLOCKS, ``f32_fwd_blocks_per_sm``): three blocks
    of its 32-row tiles at sets up to 32, two of the BIG instance's blocks
    over a cluster (at most 32 rows, and the stage of their heads' q, k
    and v for the whole set)."""
    assert _launch_bounds("fused_transformer_bf16.cu") == ft.FWD_BLOCKS == 2
    assert _launch_bounds("fused_transformer_fma.cuh") == \
        ft.FMA_FWD_BLOCKS == 2
    smem = ft.fwd_shape(torch.bfloat16, s, 4, 96, 192)[1]
    assert ft.smem_blocks_per_sm(smem) >= 2
    assert ft.fwd_blocks_per_sm(smem) == 2
    smem = ft.fma_fwd_shape(s, 4, 96, 192)[1]
    assert ft.smem_blocks_per_sm(smem) >= 2
    assert _twin_launch_bounds() == (ft.F32_BLOCKS, ft.F32_BIG_BLOCKS)
    smem = ft.fwd_shape(torch.float32, s, 4, 96, 192, 4)[1]
    bound = ft.F32_BIG_BLOCKS if s > ft.MAX_SET else ft.F32_BLOCKS
    assert ft.smem_blocks_per_sm(smem) >= bound
    assert ft.f32_fwd_blocks_per_sm(s, smem) == bound
