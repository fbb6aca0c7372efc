"""The mixture-CDF inverse (#1), ``csrc/mixture.cu``'s
``mixture_inverse_kernel``, modelled on the CPU in numpy fp32.

An element takes a group of lanes (``INV_LANES`` for K <= 8, twice as many
for K <= 16: the source's kInvLanes), lane l holding components C*l ..
C*l + C - 1 with C = 8 / INV_LANES.  Every lane runs the element's rtsafe
on the same values.  In the linear domain F and
1 - F are fmaf chains at K <= 8 and compensated sums (Dot2) above, and f
an fmaf chain over the components, relayed lane to lane in the
per-element loop's order; the
convergence floor is 2^-22 (1 + |y|), at or below the residual rule's
tau; elements with |y| >
kLinearMaxY run the log domain's three logsumexps, whose sums are relayed
the same way.  These tests check that the grid covers every (element,
component) once, that the relayed sums are the per-element loop's bit for
bit, that the model agrees with ``mixture_inverse_pallas`` (interpret mode)
and the JAX numerics to 1e-4 at the inverse's small cases, and that it
passes the residual rule of ``chip_smoke.inverse_failures`` on
``chip_smoke.inverse_cases`` (M = 65,536 among them), which refuses the
plain version cut short and the rtsafe update without its convergence
floor.  Needs neither a card nor nvcc.
"""

import importlib.util
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu.ops.pallas.mixture import mixture_inverse_pallas
from categoricalnf_tpu_torch.ops import numerics as nm
from categoricalnf_tpu_torch.ops.cuda import build
from categoricalnf_tpu_torch.ops.cuda.mixture import MAX_ITERS

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32
# The geometry and constants csrc/mixture.cu builds the inverse with
INV_LANES, THREADS = 1, 256
CONVERGED, LINEAR_MAX_Y, LINEAR_MIN = 2.0 ** -22, 64.0, 2.0 ** -100
BRACKET_SLACK = 2.0 ** -21
TPU_ITERS = 24  # the TPU kernel's rtsafe iterations, for every element
SIZES = [1, 91, 256, 65_536]
KS = [1, 3, 8, 16]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


def _source():
    with open(os.path.join(build.CSRC, "mixture.cu")) as f:
        return f.read()


def test_geometry_mirrors_the_source():
    """The model's lanes, constants and block size are the ones
    csrc/mixture.cu builds the inverse with, and its entry point launches
    kInvLanes lanes for K <= 8 and twice that for K <= 16."""
    src = _source()
    assert int(re.search(r"constexpr int kInvLanes = (\d+);", src)
               .group(1)) == INV_LANES
    assert float.fromhex(re.search(r"kConverged = (0x[0-9a-fp.+-]+)f;", src)
                         .group(1)) == CONVERGED
    assert float(re.search(r"kLinearMaxY = ([\d.]+)f;", src).group(1)) \
        == LINEAR_MAX_Y
    assert float.fromhex(re.search(r"kLinearMin = (0x[0-9a-fp.+-]+)f;", src)
                         .group(1)) == LINEAR_MIN
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == THREADS
    assert int(re.search(r"kMaxIters = (\d+);", src).group(1)) == MAX_ITERS
    assert float.fromhex(re.search(r"kBracketSlack = (0x[0-9a-fp.+-]+)f;",
                                   src).group(1)) == BRACKET_SLACK
    entry = src[src.index("int mixture_inverse_f32("):]
    entry = re.sub(r"\s+", " ",
                   entry[:entry.index("return (int)cudaGetLastError")])
    assert "if (k <= 8) inverse_launch<kInvLanes, 8 / kInvLanes>(" in entry
    assert "else inverse_launch<2 * kInvLanes, 8 / kInvLanes>(" in entry


def group_shape(k):
    """(lanes an element, components a lane) of the inverse at K = k."""
    assert 1 <= k <= 16
    return (INV_LANES if k <= 8 else 2 * INV_LANES), 8 // INV_LANES


@pytest.mark.parametrize("m", SIZES)
def test_grid_covers_every_component_once(m):
    """For K in 1, 3, 8, 16 every (element, component) is loaded by exactly
    one lane, lane 0 of each group writes its element's x, a warp holds
    whole groups, and the grid has no block beyond the last element."""
    for k in KS:
        g, c = group_shape(k)
        assert g * c == (8 if k <= 8 else 16) and 32 % g == 0
        t = np.arange(-(-m * g // THREADS) * THREADS)
        i, lane = t // g, t % g
        j = c * lane[:, None] + np.arange(c)
        live = (i[:, None] < m) & (j < k)
        assert np.array_equal(
            np.bincount((i[:, None] * k + j)[live], minlength=m * k),
            np.ones(m * k, np.int64))
        assert np.array_equal(np.bincount(i[(lane == 0) & (i < m)],
                                          minlength=m), np.ones(m, np.int64))
        assert i[-THREADS] < m


def fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def dot2(w, v):
    """The compensated sum of w[:, j] v[:, j] over j in order (the source's
    group_dot2): each product's and sum's rounding taken exactly (fmaf,
    TwoSum), summed beside, added once."""
    run, err = np.zeros(w.shape[0], F32), np.zeros(w.shape[0], F32)
    for j in range(w.shape[1]):
        p = (w[:, j] * v[:, j]).astype(F32)
        s = (run + p).astype(F32)
        bb = (s - run).astype(F32)
        e = ((run - (s - bb)).astype(F32) + (p - bb).astype(F32)).astype(F32)
        err = (err + (fma(w[:, j], v[:, j], -p) + e).astype(F32)).astype(F32)
        run = s
    return (run + err).astype(F32)


def relay(a, b, g, c, op):
    """The relay over [n, K] terms at g lanes of c components (+0 past K):
    at step t every lane applies ``op`` to its C terms and the sum so far,
    and lane t's result goes on."""
    pad = lambda v: np.concatenate(
        [v, np.zeros((v.shape[0], g * c - v.shape[1]), F32)], 1).reshape(
            -1, g, c)
    a, b = pad(a), pad(b)
    run = np.zeros(a.shape[0], F32)
    for t in range(g):
        mine = np.repeat(run[:, None], g, axis=1)
        for q in range(c):
            mine = op(a[:, :, q], b[:, :, q], mine)
        run = mine[:, t]
    return run


def test_relayed_sums_are_the_loops_bit_for_bit():
    """At the inverse's group shapes, the relayed fmaf chain (F, 1 - F and
    f) and the relayed sum (the log domain's logsumexps) give the bits of
    the per-element loop for K = 1..16 on terms over many magnitudes; a
    pairwise sum of the same terms does not, so the check can tell."""
    r = np.random.default_rng(5)
    differs = 0
    for k in range(1, 17):
        g, c = group_shape(k)
        e = (np.exp(r.standard_normal((4096, k)) * 8)
             * r.choice([-1, 1], (4096, k))).astype(F32)
        w = r.standard_normal((4096, k)).astype(F32)
        chain, total = np.zeros(4096, F32), np.zeros(4096, F32)
        for j in range(k):
            chain = fma(w[:, j], e[:, j], chain)
            total = total + e[:, j]
        assert np.array_equal(relay(w, e, g, c, fma), chain)
        assert np.array_equal(relay(e, e, g, c, lambda a, b, s: s + a),
                              total)
        tree = np.concatenate([e, np.zeros((4096, 16 - k), F32)], 1)
        while tree.shape[1] > 1:
            tree = tree[:, 0::2] + tree[:, 1::2]
        differs += int((tree[:, 0] != total).sum())
    assert differs > 0


def _logsumexp(v):
    m = v.max(axis=1)
    with np.errstate(invalid="ignore", over="ignore"):
        return (m + np.log(np.exp(v - m[:, None]).sum(axis=1,
                                                       dtype=F32))).astype(F32)


def rtsafe_update(g, step, g_floor, x, lo, hi, dx_old, converged=True):
    """rtsafe_update of the source, elementwise; without ``converged`` the
    update as the TPU kernel has it (no convergence floor)."""
    lo = np.where(g < 0, x, lo)
    hi = np.where(g < 0, hi, x)
    with np.errstate(invalid="ignore", over="ignore"):
        nxt = (x - step).astype(F32)
        bad = (~(nxt > lo) | ~(nxt < hi) | (2 * np.abs(step) > dx_old)
               | ~np.isfinite(nxt))
    mid, half = (F32(0.5) * (lo + hi)).astype(F32), (F32(0.5) * (hi - lo))
    new_x = np.where(bad, mid, nxt)
    new_dx = np.where(bad, half, np.abs(step)).astype(F32)
    if converged:
        conv = np.abs(g) <= g_floor
        inside = (nxt > lo) & (nxt < hi)
        new_x = np.where(conv, np.where(inside, nxt, x), new_x)
        new_dx = np.where(conv, np.where(inside, np.abs(step), dx_old),
                          new_dx)
    return new_x.astype(F32), lo, hi, new_dx


def model(y, pi, mu, ls, converged=True):
    """The inverse kernel's arithmetic on [...] y and [..., K] parameters,
    element by element in fp32 (the sums in the per-element loop's order,
    which the relays keep): x, the iterate with the least |g|, each element
    stopping once it is done (``rtsafe_done``: no float left between the
    bracket's ends, or the best |g| at the floor and not bettered) or after
    MAX_ITERS.  Without ``converged``, the TPU kernel's rtsafe: no
    convergence floor, no slack in the bracket, TPU_ITERS iterations, the
    last iterate returned."""
    k = pi.shape[-1]
    y = np.asarray(y, F32).reshape(-1)
    logit = np.asarray(pi, F32).reshape(-1, k)
    mean = np.asarray(mu, F32).reshape(-1, k)
    log_pi = (logit - _logsumexp(logit)[:, None]).astype(F32)
    neg_ls = -np.clip(np.asarray(ls, F32).reshape(-1, k), nm.LOG_SCALE_MIN,
                      nm.LOG_SCALE_MAX)
    inv_s = np.exp(neg_ls)
    if converged:
        sy = (np.exp(-neg_ls) * y[:, None]).astype(F32)
        cand = (mean + sy).astype(F32)
        margin = (F32(BRACKET_SLACK) * (np.abs(mean) + np.abs(sy))).astype(
            F32)
        lo0 = (cand - margin).astype(F32).min(axis=1)
        hi0 = (cand + margin).astype(F32).max(axis=1)
    else:
        cand = fma(np.exp(-neg_ls), y[:, None], mean)
        lo0, hi0 = cand.min(axis=1), cand.max(axis=1)
    g_floor = (F32(CONVERGED) * (1 + np.abs(y))).astype(F32)

    def loop(evaluate):
        x, lo, hi = (F32(0.5) * (lo0 + hi0)).astype(F32), lo0, hi0
        dx_old = (hi0 - lo0).astype(F32)
        if not converged:
            for _ in range(TPU_ITERS):
                g, step, _ = evaluate(x)
                x, lo, hi, dx_old = rtsafe_update(g, step, g_floor, x, lo,
                                                  hi, dx_old, False)
            return x
        x_best, g_best = x, np.full(x.shape, np.inf, F32)
        done = np.zeros(x.shape, bool)
        for _ in range(MAX_ITERS):
            if done.all():
                break
            g, step, known = evaluate(x)
            better = known & (np.abs(g) < g_best) & ~done
            x_best = np.where(better, x, x_best)
            g_best = np.where(better, np.abs(g), g_best)
            new = rtsafe_update(g, step, g_floor, x, lo, hi, dx_old)
            x, lo, hi, dx_old = (np.where(done, a, b) for a, b in
                                 zip((x, lo, hi, dx_old), new))
            done |= ((np.nextafter(lo, F32(np.inf)) >= hi)
                     | ((g_best <= g_floor) & ~better))
        return np.where(np.isfinite(g_best), x_best, x)

    def log_domain(x):
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            z = ((x[:, None] - mean) * inv_s).astype(F32)
            sp = np.log1p(np.exp(-np.abs(z)))
            lsp = np.where(z >= 0, -sp, z - sp).astype(F32)
            lsn = (lsp - z).astype(F32)
            a, b = log_pi + lsp, log_pi + lsn
            lc, ls_, lp = (_logsumexp(v) for v in (
                a, b, (log_pi + lsp + lsn + neg_ls).astype(F32)))
            g = (lc - ls_ - y).astype(F32)
            return g, (g * np.exp(lc + ls_ - lp)).astype(F32), True

    t_scale = (inv_s * F32(1.4426950408889634)).astype(F32)
    w = np.exp(log_pi)
    w_pdf = (w * inv_s).astype(F32)

    def linear(x):
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            t = ((x[:, None] - mean) * t_scale).astype(F32)
            e = np.exp2(-np.abs(t))
            r = (F32(1) / (F32(1) + e)).astype(F32)
            s = (e * r).astype(F32)
            sig, sig_neg = np.where(t >= 0, r, s), np.where(t >= 0, s, r)
            pair = (r * s).astype(F32)
            F = S = f = np.zeros(x.shape, F32)
            if k > 8:
                F, S = dot2(w, sig), dot2(w, sig_neg)
            for j in range(k):
                if k <= 8:
                    F = fma(w[:, j], sig[:, j], F)
                    S = fma(w[:, j], sig_neg[:, j], S)
                f = fma(w_pdf[:, j], pair[:, j], f)
            ok = np.minimum(F, S) >= F32(LINEAR_MIN)
            g = (np.log((F / S).astype(F32)) - y).astype(F32)
            step = (g * (F * S) / f).astype(F32)
        return (np.where(ok, g, np.where(S < F, F32(1), F32(-1))),
                np.where(ok, step, F32(np.nan)), ok)

    return np.where(np.abs(y) > LINEAR_MAX_Y, loop(log_domain),
                    loop(linear))


def _inputs(shape, k, seed):
    """The card tests' inputs (x, pi, mu, ls as chip_smoke.mixture_inputs
    draws them), from numpy; y the plain forward of x."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(F32)
    x, pi, mu, ls = f(*shape) * 2, f(*shape, k), f(*shape, k) * 2, \
        f(*shape, k) * 0.5 - 0.5
    y, _ = nm.mixture_logit_cdf_and_ldj(*(torch.from_numpy(t)
                                          for t in (x, pi, mu, ls)))
    return x, y.numpy(), pi, mu, ls


@pytest.mark.parametrize("shape,k", [((64, 16, 4), 8), ((7, 13), 3),
                                     ((5, 3), 16), ((1,), 1)])
def test_model_matches_the_jax_package(shape, k):
    """The model against mixture_inverse_pallas (interpret mode) and the
    JAX numerics' 42 + 3 inverse to 1e-4 at the inverse's small cases (M
    at most 4,096), and back to x to 1e-3."""
    x, y, pi, mu, ls = _inputs(shape, k, k)
    got = model(y, pi, mu, ls).reshape(shape)
    ins = tuple(jnp.asarray(t) for t in (y, pi, mu, ls))
    for want in (mixture_inverse_pallas(*ins, interpret=True),
                 jnm.mixture_inverse_logit_cdf(*ins)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(got, x, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def cases():
    """chip_smoke.inverse_cases at seed 0 on the CPU, with the plain
    version's x."""
    out = {}
    for name, (y, pi, mu, ls) in cs.inverse_cases(0, "cpu").items():
        out[name] = (y, pi, mu, ls, nm.mixture_inverse_logit_cdf(y, pi, mu,
                                                                 ls))
    return out


CASES = ["flagship", "k3", "sample4", "k16", "tails", "peaked", "far"]


@pytest.mark.parametrize("name", CASES)
def test_model_passes_the_residual_rule(cases, name):
    """The model at chip_smoke's cases (M = 65,536 with K = 8 and 3, a
    /sample of 4 sets, K = 16, the tails at y = +-60 and +-90, the peaked
    mixtures of a random coupling net, the far roots of GraphCNF's masked
    bond positions) within max(2 e_p, tau) on every element."""
    y, pi, mu, ls, x_p = cases[name]
    x = torch.from_numpy(model(*(t.numpy() for t in (y, pi, mu, ls))))
    assert cs.inverse_failures(x.reshape(y.shape), x_p, y, pi, mu, ls,
                               name) == []


@pytest.mark.parametrize("name", CASES)
def test_residual_rule_passes_plain_and_refuses_the_control(cases, name):
    """inverse_failures passes the plain version and refuses it cut short
    (12 bisections, no Newton step) at every case."""
    y, pi, mu, ls, x_p = cases[name]
    assert cs.inverse_failures(x_p, x_p, y, pi, mu, ls, name) == []
    cut = nm.mixture_inverse_logit_cdf(y, pi, mu, ls, num_bisect=12,
                                       num_newton=0)
    assert cs.inverse_failures(cut, x_p, y, pi, mu, ls, name)


def test_residual_rule_refuses_rtsafe_without_its_floor(cases):
    """Without the convergence floor and the best iterate (the TPU kernel's
    rtsafe, which returns its last iterate) some elements that converged
    from one side are thrown back by a bisection of the wide bracket, and
    the rule refuses them at M = 65,536; x stays within 1e-4 of the plain
    version, so that test could not tell."""
    y, pi, mu, ls, x_p = cases["flagship"]
    x = torch.from_numpy(model(*(t.numpy() for t in (y, pi, mu, ls)),
                               converged=False)).reshape(y.shape)
    assert cs.inverse_failures(x, x_p, y, pi, mu, ls, "no floor")
    assert float((x - x_p).abs().max()) < 1e-4


def test_residual_rule_refuses_the_old_floor_on_far_roots(cases,
                                                         monkeypatch):
    """At far roots (|y| up to 5e7) the floor 2^-20 (1 + |y|), twice the
    rule's tau there, let elements stop over the rule; at 2^-22 they pass
    (``test_model_passes_the_residual_rule``)."""
    y, pi, mu, ls, x_p = cases["far"]
    monkeypatch.setattr(sys.modules[__name__], "CONVERGED", 2.0 ** -20)
    x = torch.from_numpy(model(*(t.numpy() for t in (y, pi, mu, ls))))
    assert cs.inverse_failures(x.reshape(y.shape), x_p, y, pi, mu, ls,
                               "floor 2^-20")


def test_residual_rule_refuses_the_tpu_rtsafe_on_peaked_mixtures(cases):
    """The peaked mixtures of a coupling net with random output weights
    (wide brackets around a narrow root): the TPU kernel's rtsafe (24
    iterations, the last one returned, no slack in the bracket) leaves
    elements far over the rule, which the model of this kernel passes."""
    y, pi, mu, ls, x_p = cases["peaked"]
    x = torch.from_numpy(model(*(t.numpy() for t in (y, pi, mu, ls)),
                               converged=False)).reshape(y.shape)
    assert cs.inverse_failures(x, x_p, y, pi, mu, ls, "TPU rtsafe")
