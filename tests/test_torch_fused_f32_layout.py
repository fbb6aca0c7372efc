"""The host-side arithmetic of the fp32 fused SetTransformer forward (kernel
#3, ``csrc/fused_transformer_tf32x3.cu``), on the CPU: the TF32 split of the
weights (``rna_tf32``, ``tf32x3_layouts``), the tile and shared memory it
picks (``fwd_shape``), the calls it takes (``supported``), and its 3xTF32
arithmetic, emulated in torch for the whole net against the JAX package's
net and the port's plain path.  Needs neither a card nor nvcc."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.networks.transformer import \
    SetTransformer as JaxSetTransformer
from categoricalnf_tpu.ops.pallas import fused_transformer as jft
from categoricalnf_tpu_torch.convert import flatten_tree
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

F32 = torch.float32
# Relative norm error allowed between the fp32 forward and fp32 arithmetic:
# fp32 itself reads about 2e-7, a single TF32 pass about 3e-4.
F32_FWD_REL = 1e-5


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _unsplit(layout, kd, n):
    """(hi, lo) [..., pad8(n), pad8(kd)] of a ``tf32x3_layouts`` layout."""
    *lead, n8, k16 = layout.shape
    parts = layout.reshape(*lead, n8, k16 // 16, 4, 2, 2)
    hi, lo = (parts[..., i, :].transpose(-1, -2).reshape(*lead, n8, k16 // 2)
              for i in (0, 1))
    return hi, lo


@pytest.mark.parametrize("shape", [(4, 96), (2, 96, 288), (2, 192, 96),
                                   (96, 104), (5, 13), (2, 21, 3)])
def test_tf32_split_of_the_weights(shape):
    """hi has its low 13 mantissa bits zero; hi + lo gives W back to
    fp32's rounding (2^-22 of |W|); the pads are zero; the layout is W^T
    interleaved so that lane t reads hi[t], hi[t + 4], lo[t], lo[t + 4]."""
    w = torch.tensor(np.random.default_rng(0).standard_normal(shape),
                     dtype=F32) * 3.0
    *lead, kd, n = shape
    (layout,) = ft.tf32x3_layouts([w])
    assert layout.shape == (*lead, ft.pad8(n), 2 * ft.pad8(kd))
    hi, lo = _unsplit(layout, kd, n)
    bits = torch.cat([hi.flatten(), lo.flatten()]).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    wt = w.transpose(-1, -2)
    assert torch.equal(hi[..., :n, :kd], ft.rna_tf32(wt))
    err = (hi[..., :n, :kd].double() + lo[..., :n, :kd].double()
           - wt.double()).abs()
    assert bool((err <= 2.0 ** -22 * wt.double().abs()).all())
    # the remainder carries what hi drops
    assert float(lo[..., :n, :kd].abs().max()) > 0
    for part in (hi, lo):
        assert not part[..., n:, :].any() and not part[..., :, kd:].any()
    # lane t of k-step s: its float4 holds hi[8s+t], hi[8s+t+4], lo[...]
    flat = layout.reshape(*lead, ft.pad8(n), -1, 4, 4)
    assert torch.equal(flat[..., 0, 1, 0], hi[..., 1])
    assert torch.equal(flat[..., 0, 1, 1], hi[..., 5])
    assert torch.equal(flat[..., 0, 1, 3], lo[..., 5])


def test_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 1.5 * ulp, 3.0], dtype=F32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0],
                        dtype=F32)
    assert torch.equal(ft.rna_tf32(x), want)


# in 4, hidden 96, MLP 192 (ratio 2)
FLAGSHIP = dict(in_dim=4, hidden=96, mlp=192)


def test_fwd_shape_of_the_flagship():
    """32 rows (two sets of 16, two 16-row m-tiles) in three fp32 buffers,
    rows 4 mod 8 floats wide: h and the LN/attention output [32, 96 + 4],
    and qkv [32, 288 + 4], plus 8 floats of slack: 63 KB, three blocks an
    SM."""
    tile, smem = ft.fwd_shape(F32, 16, **FLAGSHIP)[:2]
    assert (tile, smem) == (32, 4 * (32 * (100 + 100 + 292) + 8)) \
        == (32, 63_008)
    assert ft.smem_blocks_per_sm(smem) == 3
    assert ft.smem_bytes(16, 4, 96, 192) == smem


@pytest.mark.parametrize("s", [1, 5, 6, 11, 16, 17, 24, 31, 32])
@pytest.mark.parametrize("hidden,mlp", [(96, 192), (24, 48), (256, 2048),
                                        (362, 362)])
def test_fwd_tiles_hold_whole_sets_and_fit(s, hidden, mlp):
    """Whole sets up to 32 rows (one set where a set is larger), at most
    two 16-row m-tiles, within MAX_SMEM; a net too wide for that takes
    whole sets up to 16 rows.  What fits in none of its layouts, the FFMA
    forward did not take either."""
    tile, smem = ft.fwd_shape(F32, s, 4, hidden, mlp)[:2]
    if smem > ft.MAX_SMEM:
        assert not _old_fp32_rule(s, 4, hidden, 4, mlp)
        return
    assert tile in (max(1, 32 // s) * s, max(1, 16 // s) * s)
    assert -(-tile // 16) <= 2 and smem <= ft.MAX_SMEM
    assert smem == ft.smem_bytes(s, 4, hidden, mlp)
    if hidden == 96:
        assert tile == max(1, 32 // s) * s
    if hidden == 256 and s in (1, 16):
        assert tile == 16


def _old_fp32_rule(s, in_dim, hidden, heads, mlp):
    """The FFMA fp32 forward's rule before the 3xTF32 kernel: 32-row
    tiles of whole sets padded to 8 rows, rows one float wider than the
    data, three buffers."""
    if hidden % heads or not 1 <= s <= 32:
        return False
    tile = max(1, 32 // s) * s
    tile_pad = -(-tile // 8) * 8
    return 4 * tile_pad * (2 * (hidden + 1)
                           + max(3 * hidden, mlp, in_dim) + 1) <= 232_448


def test_supported_takes_every_call_the_old_kernel_took():
    """Over sets of 1-32, widths up to 512, 1-8 heads and MLP ratios 1-8,
    every call the FFMA forward took is still taken (the 16-row tiles and
    the true-width rows are what keeps the widest)."""
    taken = 0
    for s in range(1, 33):
        x = torch.zeros(1, s, 4)
        for heads in (1, 2, 3, 4, 8):
            for hidden in range(heads, 513, 7 * heads):
                for ratio in (1, 2, 4, 8):
                    if _old_fp32_rule(s, 4, hidden, heads, ratio * hidden):
                        taken += 1
                        assert ft.supported(x, None, None, hidden, heads,
                                            ratio), (s, hidden, heads, ratio)
    assert taken > 5000


def test_supported_keeps_its_other_rules():
    """A key mask of the sets' shape is taken since the fp32 forward takes
    one; a mask of another shape, or a condition, is not; sets up to 128
    rows are taken, 129 is not."""
    x = torch.zeros(2, 16, 4)
    assert ft.supported(x, None, torch.ones(2, 16), 96, 4)
    assert not ft.supported(x, None, torch.ones(1, 16), 96, 4)
    assert not ft.supported(x, torch.ones(2, 16, 1), None, 96, 4)
    assert not ft.supported(x, None, None, 96, 5)
    assert not ft.supported(torch.zeros(2, 129, 4), None, None, 96, 4)
    assert ft.supported(torch.zeros(2, 128, 4), None, None, 96, 4)
    assert ft.supported(torch.zeros(2, 33, 4), None, None, 96, 4)


# -- the 3xTF32 arithmetic, emulated -------------------------------------

def _mm(a, w, split):
    """a @ w as the kernel's tensor-core products compute it: with
    ``split`` a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (TF32 parts, exact
    products, fp32 sums), else a single TF32 pass a_hi.b_hi."""
    a_hi, w_hi = ft.rna_tf32(a), ft.rna_tf32(w)
    y = a_hi @ w_hi
    if split:
        a_lo, w_lo = ft.rna_tf32(a - a_hi), ft.rna_tf32(w - w_hi)
        y = (a_lo @ w_hi + a_hi @ w_lo) + y
    return y


def _dense(a, w, b, split):
    """a @ w + b as the kernel computes it (``_mm``), the bias in fp32."""
    return _mm(a, w, split) + b


def _ln(h):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + 1e-5)


def _emulated_net(x, ws, heads, split=True):
    """The fp32 forward's whole net with its dense products emulated, and
    at sets above 32 (the BIG instance, whose attention runs on the tensor
    cores) its attention's QK^T and P.V too; at sets up to 32 the
    attention in fp32, as the kernel's CUDA cores take it."""
    (ew, eb, qw, qb, pw, pb, f1w, f1b, f2w, f2b, ow, ob) = ws
    B, S, _ = x.shape
    h = _dense(x, ew, eb[0], split)
    H = h.shape[-1]
    hd = H // heads
    for l in range(qw.shape[0]):
        qkv = _dense(_ln(h), qw[l], qb[l], split).reshape(B, S, 3, heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if S > ft.MAX_SET:
            p = torch.softmax(_mm(q, k.transpose(-1, -2), split)
                              * (1.0 / hd ** 0.5), dim=-1)
            o = _mm(p, v, split)
        else:
            p = torch.softmax((q @ k.transpose(-1, -2)) / hd ** 0.5, dim=-1)
            o = p @ v
        o = o.transpose(1, 2).reshape(B, S, H)
        h = h + _dense(o, pw[l], pb[l], split)
        m = torch.nn.functional.gelu(_dense(_ln(h), f1w[l], f1b[l], split),
                                     approximate="tanh")
        h = h + _dense(m, f2w[l], f2b[l], split)
    return _dense(_ln(h), ow, ob[0], split)


def _nets(s):
    hidden, heads, out = 96, 4, 104
    jnet = JaxSetTransformer(hidden_dim=hidden, num_heads=heads,
                             num_layers=2, compute_dtype="float32")
    params = jax.tree.map(np.asarray,
                          jnet.init(jax.random.PRNGKey(0), 4, out))
    r = np.random.default_rng(1)
    params["out"]["w"] = (r.standard_normal((hidden, out)) * 0.1).astype(
        np.float32)
    params["out"]["b"] = (r.standard_normal(out) * 0.1).astype(np.float32)
    tnet = SetTransformer(4, out, hidden_dim=hidden, num_heads=heads,
                          compute_dtype="float32")
    tnet.load_state_dict(flatten_tree(params))
    x = np.random.default_rng(2).standard_normal((6, s, 4)).astype(
        np.float32)
    return params, tnet, x


@pytest.mark.parametrize("s", [16, 8, 64, 128])
def test_3xtf32_net_has_fp32_accuracy(s):
    """The emulated 3xTF32 net against the JAX package's fused net in fp32
    (Pallas interpret mode on the CPU) and the port's plain path, at hidden
    96, 4 heads and 2 blocks: relative norm error within F32_FWD_REL, at
    sets of 64 and 128 with the attention's products in 3xTF32 too.  The
    control, a single TF32 pass, reads above it."""
    params, tnet, x = _nets(s)
    want = np.asarray(jft.fused_set_transformer(
        params, jnp.asarray(x), hidden_dim=96, num_heads=4, num_layers=2,
        mlp_ratio=2, compute_dtype="float32", out_dim=104))
    want = torch.tensor(want)
    xt = torch.tensor(x)
    ws = tuple(w.detach() for w in ft.flatten_params(tnet))
    with torch.no_grad():
        plain = tnet.plain_forward(xt)
        got = _emulated_net(xt, ws, 4)
        single = _emulated_net(xt, ws, 4, split=False)
    assert _rel(got, want) <= F32_FWD_REL
    assert _rel(got, plain) <= F32_FWD_REL
    assert _rel(plain, want) <= F32_FWD_REL
    assert _rel(single, plain) > F32_FWD_REL
    assert _rel(single, want) > F32_FWD_REL
