"""The tile schedule of #4's attention at sets of 33 to 128 rows, on the CPU.

#4 (the fused SetTransformer backward) recomputes each block's forward and
pulls the cotangent back through it.  At sets above 32 its attention runs
in warp tiles (``csrc/fused_transformer_bf16.cu`` on the tensor cores,
``csrc/fused_transformer_fma.cuh`` on the register tiles of the FMA units
in ``csrc/fused_transformer_tiles.cuh``):

* the recompute: a 16-row tile of one head's queries against every key of
  the set at once, the row's softmax max and sum kept for phase 1;
* phase 1 (query-major): gP, p from the kept statistics, D_i = sum_j p_ij
  gP_ij from the same tile, dS and dQ;
* phase 2 (key-major): a 16-row tile of keys against every query, p from
  the queries' statistics, dK and dV;

with the set's rows split over the blocks of a cluster as ``bwd_layout``
says.  The kernels run on the card only (``tests/test_torch_cuda.py``);
here a numpy mirror of that schedule and its rounding points (logits and
softmax in fp32, a masked key's logit -1e9 before the row's max, in bf16 p
rounded before A.V and dV, R(gP), dS entering dQ and dK as bf16 hi + lo,
every output rounded once) replaces the attention of the port's plain path,
and the net's output and every gradient are held against the reference's
fused kernel in interpret mode (``jax.grad`` through its Pallas call at
sets of 64 and 128, ``jax.vjp`` of its kernel body ``_net_forward`` on a
tile of whole sets at 48 and 100, which its tiles do not take) and, with
a key mask at 64, against the reference's masked ``apply`` (its fused
kernel takes no mask).

Tolerances: fp32 within TOL = 1e-4 of the reference's largest magnitude
(``tests/test_torch_big_sets.py``); bf16 within #4 bf16's 0.03 relative
norm (``chip_smoke.py``'s limit against plain).
"""

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
from categoricalnf_tpu_torch.networks.common import layer_norm
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once
torch.set_num_threads(1)

TOL = 1e-4
BF16_REL = 0.03
HIDDEN, HEADS, IN, OUT, LAYERS = 16, 4, 3, 10, 2
F32 = np.float32
TILE = 16  # rows of a warp's tile


def rnd(x):
    """fp32 to the nearest bf16 (ties to even), as fp32."""
    u = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def tiles(s, cluster):
    """The warps' row tiles: each block's part of the set (ceil(s /
    cluster) rows in every block but the last) in tiles of 16."""
    split = -(-s // cluster)
    for b0 in range(0, s, split):
        b1 = min(b0 + split, s)
        for r0 in range(b0, b1, TILE):
            yield r0, min(r0 + TILE, b1)


def logits(a, b, inv_root, masked_cols):
    """Scaled logits of a's rows against b's (fp32 sums of exact
    products), kMaskedLogit in the masked columns."""
    l = (a @ b.T).astype(F32) * inv_root
    l[:, masked_cols] = F32(-1e9)
    return l


def hilo(ds):
    """dS as the kernels' bf16 operands hi + lo."""
    hi = rnd(ds)
    return hi, rnd(ds - hi)


def mirror_forward(q, k, v, masked, bf16, cluster):
    """The recompute's attention of one set and head (q, k, v [S, hd] in
    fp32, bf16 values where ``bf16``): the output and each row's kept
    softmax max and sum."""
    S, hd = q.shape
    inv_root = F32(1) / np.sqrt(F32(hd))
    out = np.zeros_like(q)
    mx, sm = np.zeros(S, F32), np.zeros(S, F32)
    for r0, r1 in tiles(S, cluster):
        l = logits(q[r0:r1], k, inv_root, masked)
        m = l.max(1)
        s = np.exp(l - m[:, None]).sum(1, dtype=F32)
        p = np.exp(l - m[:, None]) * (F32(1) / s)[:, None]
        o = (rnd(p) if bf16 else p) @ v
        out[r0:r1] = rnd(o) if bf16 else o
        mx[r0:r1], sm[r0:r1] = m, s
    return out, mx, sm


def mirror_backward(q, k, v, do, masked, bf16, cluster, mx, sm):
    """Phases 1 and 2 of one set and head from the kept statistics: dq,
    dk, dv."""
    S, hd = q.shape
    inv_root = F32(1) / np.sqrt(F32(hd))
    r = rnd if bf16 else (lambda x: x)
    dq, dk, dv = (np.zeros_like(q) for _ in range(3))
    D = np.zeros(S, F32)
    for r0, r1 in tiles(S, cluster):  # phase 1, query-major
        gp = r(do[r0:r1] @ v.T)
        p = (np.exp(logits(q[r0:r1], k, inv_root, masked) - mx[r0:r1, None])
             * (F32(1) / sm[r0:r1])[:, None])
        D[r0:r1] = (p * gp).sum(1, dtype=F32)
        ds = p * (gp - D[r0:r1, None]) * inv_root
        ds[:, masked] = 0
        dq[r0:r1] = r(sum(h @ k for h in hilo(ds))) if bf16 else ds @ k
    for j0, j1 in tiles(S, cluster):  # phase 2, key-major
        lt = logits(k[j0:j1], q, inv_root, [])
        lt[masked[j0:j1]] = F32(-1e9)
        p = np.exp(lt - mx[None]) * (F32(1) / sm)[None]
        ds = p * (r(v[j0:j1] @ do.T) - D[None]) * inv_root
        ds[masked[j0:j1]] = 0
        dk[j0:j1] = r(sum(h @ q for h in hilo(ds))) if bf16 else ds @ q
        dv[j0:j1] = r(r(p) @ do)
    return dq, dk, dv


class MirrorAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(hd)) v per set and head ([B, nh, S, hd] in the
    compute dtype), forward and backward by the mirror above."""

    @staticmethod
    def forward(ctx, q, k, v, mask, cluster):
        bf16 = q.dtype == torch.bfloat16
        qn, kn, vn = (t.float().numpy() for t in (q, k, v))
        km = (np.zeros(q.shape[::2], bool) if mask is None
              else ~mask.bool().numpy())
        out = np.zeros_like(qn)
        stats = {}
        for b in range(q.shape[0]):
            for h in range(q.shape[1]):
                out[b, h], *stats[b, h] = mirror_forward(
                    qn[b, h], kn[b, h], vn[b, h], km[b], bf16, cluster)
        ctx.save_for_backward(q, k, v)
        ctx.km, ctx.stats, ctx.cluster = km, stats, cluster
        return torch.from_numpy(out).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        bf16 = q.dtype == torch.bfloat16
        qn, kn, vn, gn = (t.float().numpy() for t in (q, k, v, g))
        grads = [np.zeros_like(qn) for _ in range(3)]
        for b in range(q.shape[0]):
            for h in range(q.shape[1]):
                for out, d in zip(grads, mirror_backward(
                        qn[b, h], kn[b, h], vn[b, h], gn[b, h], ctx.km[b],
                        bf16, ctx.cluster, *ctx.stats[b, h])):
                    out[b, h] = d
        return (*(torch.from_numpy(d).to(q.dtype) for d in grads), None,
                None)


def mirror_attention(cluster):
    """A stand-in for ``SetTransformer._attention`` through the mirror."""
    def attention(self, blk, h, mask, cd):
        B, T, H = h.shape
        nh, hd = self.num_heads, H // self.num_heads
        qkv = blk.qkv(layer_norm(h), cd).reshape(B, T, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = MirrorAttention.apply(q, k, v, mask, cluster)
        return blk.proj(out.transpose(1, 2).reshape(B, T, H), cd)
    return attention


def _nets(s, seed, cd):
    """The reference's SetTransformer and the port's on the same weights
    (output layer random), in ``cd``."""
    r = np.random.default_rng(seed)
    j = JaxSetTransformer(hidden_dim=HIDDEN, num_heads=HEADS,
                          num_layers=LAYERS, compute_dtype=cd)
    params = jax.tree.map(np.asarray, j.init(jax.random.PRNGKey(seed), IN,
                                             OUT))
    params["out"]["w"] = (r.standard_normal(params["out"]["w"].shape)
                          * 0.3).astype(F32)
    net = SetTransformer(IN, OUT, hidden_dim=HIDDEN, num_heads=HEADS,
                         num_layers=LAYERS, compute_dtype=cd)
    net.load_state_dict(flatten_tree(params))
    return j, params, net


def _reference(j, params, x, g, s, cd, mask):
    """The reference's output and gradients (x, then its parameters by
    name): its fused kernel at 64 and 128, its kernel body on one tile of
    whole sets at the other sizes, its masked apply with a mask."""
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

    def loss(p, xx):
        y = fn(p, xx).astype(jnp.float32)
        return jnp.sum(y * g), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    y = np.asarray(y)
    want = {k: np.asarray(v) for k, v in flatten_tree(gp).items()}
    return y, np.asarray(gx), want


def _close(got, want, bf16, what):
    if bf16:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= BF16_REL, f"{what}: relative norm {err}"
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1.0),
            err_msg=what)


CASES = [(s, cd, False) for s in (48, 64, 100, 128)
         for cd in ("float32", "bfloat16")] + [
    (64, cd, True) for cd in ("float32", "bfloat16")]


@pytest.mark.parametrize("s,cd,masked", CASES)
def test_mirror_of_the_tile_schedule_matches_the_reference(s, cd, masked,
                                                           monkeypatch):
    """The port's net with the mirror's attention (the set split over the
    cluster that #4 takes at this width) against the reference, on 2 sets
    (with a key mask: set 0 one valid key, set 1 a ragged prefix)."""
    j, params, net = _nets(s, s + masked, cd)
    dt = getattr(torch, cd)
    cluster = ft.bwd_layout(dt, s, IN, HIDDEN, 2 * HIDDEN, OUT, HEADS,
                            LAYERS)[3]
    r = np.random.default_rng(s + 1)
    x = r.standard_normal((2, s, IN)).astype(F32)
    g = r.standard_normal((2, s, OUT)).astype(F32)
    mask = None
    if masked:
        mask = np.zeros((2, s), F32)
        mask[0, 0] = 1
        mask[1, :s // 3] = 1
    want_y, want_gx, want = _reference(j, params, x, g, s, cd, mask)
    monkeypatch.setattr(SetTransformer, "_attention",
                        mirror_attention(cluster))
    xt = torch.tensor(x, requires_grad=True)
    y = net(xt, mask=None if mask is None else torch.tensor(mask))
    names, params_t = zip(*net.named_parameters())
    grads = torch.autograd.grad(y, [xt, *params_t],
                                torch.tensor(g).to(y.dtype))
    bf16 = cd == "bfloat16"
    _close(y.detach().float().numpy(), want_y, bf16, "y")
    _close(grads[0].float().numpy(), want_gx, bf16, "dx")
    assert set(names) == set(want)
    for name, got in zip(names, grads[1:]):
        _close(got.float().numpy(), want[name].reshape(got.shape), bf16,
               name)


@pytest.mark.parametrize("s", [33, 48, 64, 100, 128])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mirror_matches_plain_attention(s, cd):
    """One head of one set: the mirror's output and dq, dk, dv against
    autograd of the plain path's attention (fp32 products of the same
    operands, p rounded to the compute dtype before A.V), with a ragged
    key mask; fp32 within TOL of the largest magnitude, bf16 within 0.03
    relative norm; the tiles cover every row once."""
    r = np.random.default_rng(s)
    hd = 24
    bf16 = cd == "bfloat16"
    q, k, v, do = (r.standard_normal((s, hd)).astype(F32) for _ in range(4))
    if bf16:
        q, k, v, do = map(rnd, (q, k, v, do))
    masked = np.arange(s) >= s - 5
    cluster = 2 if s <= 64 else 4
    rows = [i for r0, r1 in tiles(s, cluster) for i in range(r0, r1)]
    assert rows == list(range(s))
    out, mx, sm = mirror_forward(q, k, v, masked, bf16, cluster)
    dq, dk, dv = mirror_backward(q, k, v, do, masked, bf16, cluster, mx, sm)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    lg = (qt @ kt.T) / np.sqrt(hd)
    lg = lg.masked_fill(torch.tensor(masked)[None], -1e9)
    p = torch.softmax(lg, -1)
    if bf16:
        p = p.to(torch.bfloat16).float()
    o = p @ vt
    want = [o.detach().numpy(), *(t.numpy() for t in torch.autograd.grad(
        o, [qt, kt, vt], torch.tensor(do)))]
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                          want):
        _close(a, b, bf16, name)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [33, 48, 64, 65, 99, 100, 128])
def test_big_attention_layout_at_sets_up_to_128(cd, s):
    """The warp tiles keep logits, probabilities and cotangents in
    registers, so #4's layout at sets of 33 to 128 is the one it had and
    fits at the flagship's width and at a narrow one in both dtypes; in
    bf16 the other block's rows a pass reads are copied once into two
    buffers of the tile that the pass leaves dead (``bf16_big_stage``),
    and fit there at every set (fp32 reads them through distributed shared
    memory)."""
    for hidden in (96, 16):
        tile, smem, _, cluster = ft.bwd_layout(cd, s, 4, hidden,
                                               2 * hidden, 104, HEADS,
                                               LAYERS)
        assert smem <= ft.MAX_SMEM
        assert tile == ft.split_rows(s, cluster)
        assert tile * (cluster - 1) < s <= tile * cluster
        if cd == torch.bfloat16:
            need, room = ft.bf16_big_stage(s, hidden, cluster)
            assert (need > 0) == (cluster > 1) and need <= room
