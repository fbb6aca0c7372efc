"""The lane layout and the sums of the mixture-CDF forward (#2) and its
backward (#2'), ``csrc/mixture.cu``, modelled on the CPU in numpy fp32.

An element takes a group of lanes (``FWD_LANES`` or ``BWD_LANES`` for
K <= 8, twice as many for K <= 16: the source's kFwdLanes and kBwdLanes),
lane l holding components C*l .. C*l + C - 1.  Every sum over the
components is relayed: lane 0 adds its terms to 0.0f, lane 1 adds its own
to that, and so on.  These tests check that the
grid covers every (element, component) once, that the relayed sums are the
per-element loop's sums bit for bit, and that the model of the kernels'
arithmetic agrees with the JAX package: its numerics, their ``jax.vjp`` and
``mixture_forward_pallas`` in interpret mode.  Needs neither a card nor
nvcc.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu.ops.pallas.mixture import mixture_forward_pallas
from categoricalnf_tpu_torch.ops.cuda import build

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

F32 = np.float32
MAX_K = 16
# The launch geometry csrc/mixture.cu builds with: lanes an element at
# K <= 8 of the forward and of the backward, and threads a block
FWD_LANES, BWD_LANES, THREADS = 2, 4, 256
KERNELS = {"forward": FWD_LANES, "backward": BWD_LANES}
SIZES = [1, 91, 65_536, 262_144]


def group_shape(kernel_lanes, k):
    """(lanes an element, components a lane) of a kernel whose group has
    ``kernel_lanes`` lanes for K <= 8."""
    assert 1 <= k <= MAX_K
    return (kernel_lanes if k <= 8 else 2 * kernel_lanes), 8 // kernel_lanes


def blocks(m, lanes):
    """Blocks of ``THREADS`` lanes for ``m`` elements of ``lanes`` each."""
    return -(-m * lanes // THREADS)


def test_geometry_mirrors_the_source():
    """The model's lanes and block size are the ones csrc/mixture.cu
    builds with."""
    src = open(os.path.join(build.CSRC, "mixture.cu")).read()
    lanes = re.search(r"constexpr int kFwdLanes = (\d+), kBwdLanes = (\d+);",
                      src)
    assert (int(lanes.group(1)), int(lanes.group(2))) == (FWD_LANES,
                                                          BWD_LANES)
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == THREADS


LAUNCHERS = {"forward": ("forward_launch", "kFwdLanes"),
             "backward": ("bwd_launch", "kBwdLanes")}


@pytest.mark.parametrize("kernel", KERNELS)
def test_group_shape(kernel):
    """Groups of 2 (forward) or 4 (backward) lanes for K <= 8 and twice
    that for K <= 16, 8 / lanes components a lane, as the C entry points
    of csrc/mixture.cu launch them; a warp and a block hold whole
    groups."""
    src = open(os.path.join(build.CSRC, "mixture.cu")).read()
    launch, lanes_name = LAUNCHERS[kernel]
    entry = src[src.index(f"{launch}<{lanes_name}, 8 / {lanes_name}>(x"):]
    entry = entry[:entry.index("return")]
    assert re.sub(r"\s+", " ", entry).count(
        f"{launch}<2 * {lanes_name}, 8 / {lanes_name}>(") == 1
    assert "if (k <= 8)" in src[src.index(f"{launch}<{lanes_name}") - 40:
                                src.index(f"{launch}<{lanes_name}")]
    lanes = KERNELS[kernel]
    for k in range(1, 17):
        g, c = group_shape(lanes, k)
        assert g == (lanes if k <= 8 else 2 * lanes) and c == 8 // lanes
        assert g * c == (8 if k <= 8 else 16)
        assert 32 % g == 0 and THREADS % g == 0


def lane_map(m, k, lanes):
    """Per thread of the launch: element i, lane l, and per slot its
    component j and whether it is live (i < m and j < k)."""
    g, c = group_shape(lanes, k)
    t = np.arange(blocks(m, g) * THREADS)
    i, l = t // g, t % g
    j = c * l[:, None] + np.arange(c)
    return i, l, j, (i[:, None] < m) & (j < k)


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_grid_covers_every_component_once(kernel, m):
    """For K = 1..16 every (element, component) is loaded, and every
    gradient element stored, by exactly one lane; lane 0 of each group
    writes its element's scalars; a warp's stores of the [M, K] gradients
    fill one contiguous run, and the grid has no block beyond the last
    element."""
    for k in range(1, 17):
        i, l, j, live = lane_map(m, k, KERNELS[kernel])
        g = group_shape(KERNELS[kernel], k)[0]
        offsets = (i[:, None] * k + j)[live]
        assert np.array_equal(np.bincount(offsets, minlength=m * k),
                              np.ones(m * k, np.int64))
        assert np.array_equal(np.bincount(i[(l == 0) & (i < m)],
                                          minlength=m), np.ones(m, np.int64))
        assert i[-THREADS] < m  # the last block holds an element
        warps = np.broadcast_to((np.arange(i.size) // 32)[:, None],
                                live.shape)[live]
        first = np.full(warps.max() + 1, np.iinfo(np.int64).max)
        last = np.zeros(warps.max() + 1, np.int64)
        np.minimum.at(first, warps, offsets)
        np.maximum.at(last, warps, offsets)
        assert np.array_equal(np.bincount(warps), last - first + 1)
        # warp w holds elements w * 32 / G onwards
        assert np.array_equal(i[::32], np.arange(i.size // 32) * (32 // g))


def loop_sum(e):
    """The per-element loop's sum: 0.0f + e[0] + e[1] + ... in order."""
    s = np.zeros(e.shape[0], F32)
    for j in range(e.shape[1]):
        s = s + e[:, j]
    return s


def group_sum(v):
    """group_sum's relay over v [n, G, C] (components C*l + c; +0 where
    j >= k): at step t every lane adds its C terms to the sum so far and
    lane t's result goes on."""
    run = np.zeros(v.shape[0], F32)
    for t in range(v.shape[1]):
        mine = np.repeat(run[:, None], v.shape[1], axis=1)
        for c in range(v.shape[2]):
            mine = mine + v[:, :, c]
        run = mine[:, t]
    return run


def group_dot(a, b):
    """group_dot's relay: the fmaf chain over the components in order (an
    fp32 fma as the exact product and sum in float64, rounded once)."""
    run = np.zeros(a.shape[0], F32)
    for t in range(a.shape[1]):
        mine = np.repeat(run[:, None], a.shape[1], axis=1)
        for c in range(a.shape[2]):
            mine = fma(a[:, :, c], b[:, :, c], mine)
        run = mine[:, t]
    return run


def fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def to_lanes(v, g, c, fill=0.0):
    """[n, K] -> [n, G, C] in the kernels' lane order, padded with fill."""
    out = np.full((v.shape[0], g * c), fill, F32)
    out[:, :v.shape[1]] = v
    return out.reshape(-1, g, c)


@pytest.mark.parametrize("kernel", KERNELS)
def test_relayed_sums_are_the_loops_bit_for_bit(kernel):
    """group_sum and group_dot give the bits of the per-element loop's sum
    and fmaf chain for K = 1..16 on terms over many magnitudes; a butterfly
    (pairwise) sum of the same terms does not, so the check can tell."""
    r = np.random.default_rng(3)
    differs = 0
    for k in range(1, 17):
        g, c = group_shape(KERNELS[kernel], k)
        e = (np.exp(r.standard_normal((4096, k)) * 8)
             * r.choice([-1, 1], (4096, k))).astype(F32)
        w = r.standard_normal((4096, k)).astype(F32)
        assert np.array_equal(group_sum(to_lanes(e, g, c)), loop_sum(e))
        chain = np.zeros(4096, F32)
        for j in range(k):
            chain = fma(e[:, j], w[:, j], chain)
        assert np.array_equal(group_dot(to_lanes(e, g, c),
                                        to_lanes(w, g, c)), chain)
        tree = to_lanes(e, 1, 16)[:, 0]
        while tree.shape[1] > 1:
            tree = tree[:, 0::2] + tree[:, 1::2]
        differs += int((tree[:, 0] != loop_sum(e)).sum())
    assert differs > 0


def log_sigmoid_pair(z):
    sp = np.log1p(np.exp(-np.abs(z)))
    lsp = np.where(z >= 0, -sp, z - sp).astype(F32)
    return lsp, (lsp - z).astype(F32)


def group_logsumexp(v, on):
    m = np.where(on, v, -np.inf).max(axis=(1, 2))
    with np.errstate(invalid="ignore", over="ignore"):
        e = np.where(on, np.exp(v - m[:, None, None]), F32(0)).astype(F32)
    return (m + np.log(group_sum(e))).astype(F32)


def model(x, pi, mu, ls, gy, gl, lanes):
    """The forward and backward kernels' arithmetic, lane by lane, on
    [M] x and [M, K] parameters: (y, ldj) and (gx, gpi, gmu, gls)."""
    m, k = pi.shape
    g, c = group_shape(lanes, k)
    on = to_lanes(np.ones((m, k), F32), g, c) > 0
    logit = to_lanes(pi, g, c, -np.inf)
    mean, raw_ls = to_lanes(mu, g, c), to_lanes(ls, g, c)
    xs = x[:, None, None]
    log_pi = logit - group_logsumexp(logit, on)[:, None, None]
    neg_ls = -np.clip(raw_ls, jnm.LOG_SCALE_MIN, jnm.LOG_SCALE_MAX)
    inv_s = np.exp(neg_ls)
    z = (xs - mean) * inv_s
    lsp, lsn = log_sigmoid_pair(z)
    a, b = log_pi + lsp, log_pi + lsn
    cc = log_pi + lsp + lsn + neg_ls
    la, lb, lc = (group_logsumexp(t, on)[:, None, None] for t in (a, b, cc))
    y, ldj = la - lb, lc - la - lb
    g_y, g_l = gy[:, None, None], gl[:, None, None]
    g_a, g_b, g_c = g_y - g_l, -g_y - g_l, g_l
    with np.errstate(invalid="ignore", over="ignore"):
        ea = np.exp(a - la)
        gb = g_b * np.exp(b - lb)
        gc = g_c * np.exp(cc - lc)
        gz = fma(fma(g_a, ea, gc), np.exp(lsp - z),
                 -((gb + gc) * np.exp(lsp)))
        d_log_pi = np.where(on, fma(g_a, ea, gb) + gc, F32(0)).astype(F32)
    gz = np.where(on, gz, F32(0)).astype(F32)
    gx = group_dot(gz, np.where(on, inv_s, F32(0)).astype(F32))
    g_lp = group_sum(d_log_pi)[:, None, None]
    inside = (raw_ls >= jnm.LOG_SCALE_MIN) & (raw_ls <= jnm.LOG_SCALE_MAX)
    gls = np.where(inside, fma(-gz, z, -gc), F32(0))
    gpi = fma(np.exp(log_pi), -g_lp, d_log_pi)
    back = tuple(t.reshape(m, g * c)[:, :k] for t in (gpi, -gz * inv_s, gls))
    return (y[:, 0, 0], ldj[:, 0, 0]), (gx,) + back


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [1, 3, 8, 9, 16])
def test_model_matches_the_jax_package(k):
    """The model of both kernels (at their own group widths) against the
    JAX numerics, their jax.vjp and mixture_forward_pallas (interpret
    mode) to 1e-4, with log-scales on both sides of the clip."""
    r = np.random.default_rng(k)
    f = lambda *s: r.standard_normal(s).astype(F32)
    m = 91
    x, pi, mu, ls = f(m) * 2.0, f(m, k), f(m, k) * 2.0, f(m, k) * 3.0 - 0.5
    gy, gl = f(m), f(m)
    clipped = (ls < jnm.LOG_SCALE_MIN) | (ls > jnm.LOG_SCALE_MAX)
    assert clipped.any() and not clipped.all()
    (y, ldj), _ = model(x, pi, mu, ls, gy, gl, FWD_LANES)
    _, grads = model(x, pi, mu, ls, gy, gl, BWD_LANES)
    ins = tuple(jnp.asarray(t) for t in (x, pi, mu, ls))
    (y_j, ldj_j), vjp = jax.vjp(jnm.mixture_logit_cdf_and_ldj, *ins)
    _close(y, y_j)
    _close(ldj, ldj_j)
    y_p, ldj_p = mixture_forward_pallas(*ins, interpret=True)
    _close(y, y_p)
    _close(ldj, ldj_p)
    for got, want in zip(grads, vjp((jnp.asarray(gy), jnp.asarray(gl)))):
        _close(got, want)
    assert np.all(grads[3][clipped] == 0)
