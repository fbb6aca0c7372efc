"""The port's encodings and the flows they need against the JAX package, on
the CPU.

The checker-masked coupling with an MLP net, the MLP, Logit and Sigmoid,
the conditional affine (forward and inverse, z and ldj); each encoding and
learned decoder (``encode`` on shared uniforms, ``log_decoder``,
``decode``); the inverse's backward: the plain implicit rule (#1''s plain
version) against the exact derivative and against ``jax.vjp`` of the
reference's inverse where that loop's last Newton step stayed inside its
bracket, and the port's CPU autograd through the same loop against
``jax.vjp``; last, the shapes the SetTransformer kernels take (the card's
wrappers raise on others).  Parameters are the reference's, carried by
``flatten_tree`` / ``convert.from_jax_params``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu import encodings as jenc
from categoricalnf_tpu import flows as jflows
from categoricalnf_tpu.flows.cond_affine import \
    ConditionalAffine as JaxConditionalAffine
from categoricalnf_tpu.networks.mlp import MLP as JaxMLP
from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu_torch import encodings as tenc
from categoricalnf_tpu_torch import flows as tflows
from categoricalnf_tpu_torch.convert import flatten_tree
from categoricalnf_tpu_torch.networks import MLP
from categoricalnf_tpu_torch.ops import numerics as nm
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

B, T, E, C = 8, 6, 16, 5  # sets, positions, embedding width, categories
TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _randomize_last(layers, seed, scale=0.1):
    """A zero-initialised last layer makes a coupling or an affine the
    identity; give it random weights."""
    for k in ("w", "b"):
        layers[k] = _rand(seed + (k == "b"), layers[k].shape, scale)


def _both(jlayer, jparams, tlayer, z, cond=None):
    """(forward z, forward ldj, inverse z, inverse ldj) of both layers."""
    zero = np.zeros(z.shape[0], np.float32)
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.tensor(cond)
    j = [np.asarray(a) for a in (
        *jlayer.forward(jparams, jnp.asarray(z), zero, cond=jc),
        *jlayer.inverse(jparams, jnp.asarray(z), zero, cond=jc))]
    with torch.no_grad():
        t = [a.numpy() for a in (
            *tlayer(torch.tensor(z), torch.tensor(zero), cond=tc),
            *tlayer.inverse(torch.tensor(z), torch.tensor(zero), cond=tc))]
    return j, t


@pytest.mark.parametrize("parity", [0, 1])
def test_checker_coupling_matches_reference(parity):
    """A checker-masked mixture-CDF coupling on dim 1 with an MLP net and
    a condition, as the dequantization flow has it: z and ldj of both
    directions within 1e-4; the conditioning positions pass unchanged."""
    K = 4
    jl = jflows.MixtureCDFCoupling(
        net=JaxMLP(hidden_dim=16, num_layers=2, compute_dtype="float32"),
        mask_kind="checker", parity=parity, num_mixtures=K)
    params = _np(jl.init(jax.random.PRNGKey(parity), 1, E))
    _randomize_last(params["net"][-1], 3)
    tl = tflows.MixtureCDFCoupling(
        MLP(1, 2 + 3 * K, E, hidden_dim=16, compute_dtype="float32"), 1,
        parity=parity, num_mixtures=K, mask_kind="checker")
    tl.load_state_dict(flatten_tree(params))
    z, cond = _rand(4, (B, T, 1), 1.5), _rand(5, (B, T, E))
    j, t = _both(jl, params, tl, z, cond)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    kept = np.asarray(jflows.make_checker_mask(T, parity)) > 0
    np.testing.assert_array_equal(t[0][:, kept], z[:, kept])
    np.testing.assert_array_equal(
        tflows.make_checker_mask(T, parity).numpy(),
        np.asarray(jflows.make_checker_mask(T, parity)))


@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_mlp_matches_reference(cd, tol):
    """The MLP with a condition.  fp32 within 1e-5; bf16 within 2e-2 of
    the output's largest magnitude (2-3 bf16 ulps: the frameworks sum the
    fp32 products in another order and round the bf16 gelu differently,
    so a rounding can flip)."""
    j = JaxMLP(hidden_dim=16, num_layers=2, compute_dtype=cd)
    params = _np(j.init(jax.random.PRNGKey(0), 3, 7, E))
    _randomize_last(params[-1], 1)
    net = MLP(3, 7, E, hidden_dim=16, compute_dtype=cd)
    net.load_state_dict(flatten_tree(list(params)))
    x, cond = _rand(2, (B, T, 3)), _rand(3, (B, T, E))
    want = np.asarray(j.apply(params, jnp.asarray(x),
                              cond=jnp.asarray(cond))).astype(np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x), cond=torch.tensor(cond)).float().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    zero = MLP(3, 7, E, hidden_dim=16)
    assert not zero[-1].w.any() and not zero[-1].b.any()


@pytest.mark.parametrize("name", ["Logit", "Sigmoid"])
def test_sigmoid_and_logit_match_reference(name):
    """Both directions within 1e-5 (z and ldj), with values at the clip
    of the logit's input."""
    jl, tl = getattr(jflows, name)(), getattr(tflows, name)()
    r = np.random.default_rng(6)
    unit = r.uniform(0, 1, (B, T, 2)).astype(np.float32)
    unit[0, 0] = [0.0, 1.0]
    real = _rand(7, (B, T, 2), 3.0)
    zf, zi = (unit, real) if name == "Logit" else (real, unit)
    zero = np.zeros(B, np.float32)
    jf = jl.forward({}, jnp.asarray(zf), zero)
    ji = jl.inverse({}, jnp.asarray(zi), zero)
    tf = tl(torch.tensor(zf), torch.tensor(zero))
    ti = tl.inverse(torch.tensor(zi), torch.tensor(zero))
    for a, b in zip((*tf, *ti), (*jf, *ji)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_conditional_affine_matches_reference():
    """z and ldj of both directions within 1e-5; the zero fc2 of a new
    layer makes it the identity."""
    jl = JaxConditionalAffine()
    params = _np(jl.init(jax.random.PRNGKey(2), 3, E))
    _randomize_last(params["fc2"], 8)
    tl = tflows.ConditionalAffine(3, E)
    assert not tl.fc2.w.any()
    tl.load_state_dict(flatten_tree(params))
    j, t = _both(jl, params, tl, _rand(9, (B, T, 3)), _rand(10, (B, T, E)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _encoding_pair(name, **kw):
    """An encoding of both frameworks on the reference's parameters, its
    encoder flow's zero layers randomised."""
    dim = 1 if name == "vardeq" else 2
    jkw = {k: v for k, v in kw.items() if k != "compute_dtype"}
    je = jenc.create_encoding(name, num_categories=C, dim=dim, **jkw)
    params = _np(je.init(jax.random.PRNGKey(3)))
    for i, layer in enumerate(params.get("flow", ())):
        if "net" in layer:
            _randomize_last(layer["net"][-1], 20 + i)
        elif "fc2" in layer:
            _randomize_last(layer["fc2"], 20 + i)
    te = tenc.create_encoding(name, C, dim, **kw)
    flat = flatten_tree({k: v for k, v in params.items() if k != "flow"})
    flat.update(flatten_tree(list(params.get("flow", ())), "flow.layers."))
    te.load_state_dict(flat)
    return je, params, te, dim


ENCODINGS = [("vardeq", dict(hidden_dim=16)),
             ("linear_flows", dict(hidden_dim=16)),
             ("mixture", dict(decoder="linear")),
             ("mixture", dict(decoder="mlp"))]


@pytest.mark.parametrize("name,kw", ENCODINGS,
                         ids=["vardeq", "linear_flows", "mixture-linear",
                              "mixture-mlp"])
def test_encoding_matches_reference(name, kw):
    """``encode`` on the same uniform draw: z and log q(z|x) within 1e-4;
    ``log_decoder`` of that z within 1e-4 (vardeq's is 0); ``decode`` of it
    equal to the reference's and, for the encoders that round or decode by
    Bayes, to x itself on most positions."""
    je, params, te, dim = _encoding_pair(name, **kw)
    r = np.random.default_rng(11)
    x = r.integers(0, C, (B, T))
    mask = (np.arange(T)[None] < r.integers(3, T + 1, (B, 1))).astype(
        np.float32)
    key = jax.random.PRNGKey(12)
    u = np.asarray(jax.random.uniform(
        key, (B * T, 1, dim) if name == "linear_flows" else (B, T, dim),
        jnp.float32, minval=1e-6, maxval=1.0 - 1e-6)).reshape(B, T, dim)
    jz, jlog_q = jax.jit(je.encode)(params, jnp.asarray(x), key,
                                    mask=jnp.asarray(mask))
    jdec = jax.jit(je.log_decoder)(params, jnp.asarray(x), jz,
                                   mask=jnp.asarray(mask))
    jx = jax.jit(je.decode)(params, jz)
    with torch.no_grad():
        tz, tlog_q = te.encode(torch.tensor(x), mask=torch.tensor(mask),
                               noise=torch.tensor(u))
        tdec = te.log_decoder(torch.tensor(x), tz, mask=torch.tensor(mask))
        tx = te.decode(tz)
    for a, b in ((tz, jz), (tlog_q, jlog_q), (tdec, jdec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if name == "vardeq":
        np.testing.assert_array_equal(tx.numpy(), x)
        assert not tdec.any()


def test_vardeq_forces_dim_1_and_the_factory_names():
    assert tenc.create_encoding("vardeq", C, 4).dim == 1
    assert isinstance(tenc.create_encoding("linear", C, 3),
                      tenc.LinearFlowEncoding)
    assert isinstance(tenc.create_encoding("variational_dequantization", C),
                      tenc.VariationalDequantization)
    with pytest.raises(ValueError, match="unknown encoding"):
        tenc.create_encoding("bogus", C)
    with pytest.raises(ValueError, match="unknown decoder"):
        tenc.create_encoding("mixture", C, decoder="bogus")


# -- the inverse's backward --------------------------------------------------

def _inverse_inputs(seed, near_zero):
    """y = logit F(x) of drawn x (a share ``near_zero`` of them within
    ~1e-6 of 0, where fp32's grid is fine enough that the reference's
    bracket does not close on two neighbouring floats), K = 4 mixtures."""
    r = np.random.default_rng(seed)
    shape, k = (64, 8), 4
    x = r.standard_normal(shape) * 2
    x = np.where(r.random(shape) < near_zero, x * 1e-6, x).astype(np.float32)
    pi = _rand(seed + 1, shape + (k,))
    mu = _rand(seed + 2, shape + (k,), 2.0)
    ls = _rand(seed + 3, shape + (k,), 0.5) - 0.5
    y, _ = nm.mixture_logit_cdf_and_ldj(*map(torch.tensor, (x, pi, mu, ls)))
    return y.numpy(), pi, mu, ls, _rand(seed + 4, shape)


def _last_newton_clipped(y, pi_logits, means, log_scales):
    """The reference's inverse (``numerics.mixture_inverse_logit_cdf``,
    42 bisections and 3 Newton steps) written out again, returning its
    root and whether its last Newton step left, or landed on, the bracket
    (then ``jnp.clip`` sends part or all of the gradient through the
    bracket's ends instead of the step)."""
    lse = jax.scipy.special.logsumexp
    log_pi = jax.nn.log_softmax(pi_logits, axis=-1)
    log_scales = jnp.clip(log_scales, jnm.LOG_SCALE_MIN, jnm.LOG_SCALE_MAX)
    cand = means + jnp.exp(log_scales) * y[..., None]
    lo, hi = jnp.min(cand, axis=-1), jnp.max(cand, axis=-1)
    inv_scales = jnp.exp(-log_scales)

    def parts(x):
        z = (x[..., None] - means) * inv_scales
        a, b = jnm._log_sigmoid_pair(z)
        return (lse(log_pi + a, axis=-1), lse(log_pi + b, axis=-1),
                lse(log_pi + a + b - log_scales, axis=-1))

    def bisect(_, c):
        lo, hi = c
        mid = 0.5 * (lo + hi)
        log_cdf, log_sf, _ = parts(mid)
        right = (log_cdf - log_sf) < y
        return jnp.where(right, mid, lo), jnp.where(right, hi, mid)

    lo, hi = jax.lax.fori_loop(0, 42, bisect, (lo, hi))
    x = 0.5 * (lo + hi)
    for _ in range(3):
        log_cdf, log_sf, log_pdf = parts(x)
        v = x - (log_cdf - log_sf - y) * jnp.exp(log_cdf + log_sf - log_pdf)
        clipped = (v <= lo) | (v >= hi)
        x = jnp.clip(v, lo, hi)
    return x, clipped


def _jax_vjp(y, pi, mu, ls, gx):
    x, vjp = jax.vjp(jax.jit(jnm.mixture_inverse_logit_cdf),
                     *map(jnp.asarray, (y, pi, mu, ls)))
    return np.asarray(x), [np.asarray(g) for g in vjp(jnp.asarray(gx))]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_vjp_is_the_exact_derivative(seed):
    """The plain implicit rule in fp32, at the fp32 root, against the exact
    derivative (central differences of the plain inverse in float64,
    ``chip_smoke.inverse_exact_vjp``): each gradient within
    1e-4 of its norm (it reads under 2e-6).  The reference's own fp32
    gradient (``jax.vjp`` of its loop) is held beside it: 0.1 or more off
    in every tensor, since its clipped Newton steps send the gradient
    through the bracket's ends."""
    y, pi, mu, ls, gx = _inverse_inputs(seed, 0.0)
    x = nm.mixture_inverse_logit_cdf(*map(torch.tensor, (y, pi, mu, ls)))
    got = nm.mixture_inverse_vjp(x, *map(torch.tensor, (pi, mu, ls, gx)))
    exact = [e.numpy() for e in cs.inverse_exact_vjp(
        *map(torch.tensor, (y, pi, mu, ls, gx)))]
    _, ref = _jax_vjp(y, pi, mu, ls, gx)
    for g, e, r in zip(got, exact, ref):
        assert g.dtype == torch.float32
        assert _rel(g.double().numpy(), e) < 1e-4
        assert _rel(r, e) > 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_vjp_matches_reference_where_newton_is_unclipped(seed):
    """The plain implicit rule at the reference's root against ``jax.vjp``
    of the reference's inverse, on the elements whose last Newton step
    stayed strictly inside its bracket: each within 1e-3 of itself plus
    1e-5 of the tensor's largest magnitude (it reads up to 3e-6 of that;
    the rest is the bracket's gradient leaking through the earlier steps).
    With half the roots near 0 about 20% of the elements are such; every
    other element is outside the limit or may be (the reference's
    gradient goes through its bracket's ends there), and with ordinary
    roots no element is unclipped."""
    y, pi, mu, ls, gx = _inverse_inputs(seed, 0.5)
    x_mirror, clipped = jax.jit(_last_newton_clipped)(
        *map(jnp.asarray, (y, pi, mu, ls)))
    x, ref = _jax_vjp(y, pi, mu, ls, gx)
    np.testing.assert_array_equal(np.asarray(x_mirror), x)
    free = ~np.asarray(clipped)
    assert 0.1 < free.mean() < 0.4
    got = nm.mixture_inverse_vjp(torch.tensor(x),
                                 *map(torch.tensor, (pi, mu, ls, gx)))
    for g, r in zip(got, ref):
        g = g.numpy()
        m = free if g.shape == free.shape else np.broadcast_to(
            free[..., None], g.shape)
        over = np.abs(g - r) > 1e-3 * np.abs(r) + 1e-5 * np.abs(r).max()
        assert not over[m].any()
        assert over.mean() <= (~m).mean()
    y, pi, mu, ls, _ = _inverse_inputs(seed, 0.0)
    _, clipped = jax.jit(_last_newton_clipped)(
        *map(jnp.asarray, (y, pi, mu, ls)))
    assert np.asarray(clipped).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_inverse_autograd_matches_reference(seed):
    """The port's CPU gradient, autograd through the plain loop, against
    ``jax.vjp`` of the reference's loop: the two loops run the same steps,
    and their derivatives are the bracket's where the steps clip, so they
    agree where both loops make the same choices: within 1e-3 of itself
    plus 1e-4 of the tensor's largest magnitude on at least 90% of the
    elements (93-95% measured); a one-ulp difference of a bisection's
    midpoint sends the rest another way."""
    y, pi, mu, ls, gx = _inverse_inputs(seed, 0.0)
    _, ref = _jax_vjp(y, pi, mu, ls, gx)
    ts = [torch.tensor(a, requires_grad=True) for a in (y, pi, mu, ls)]
    got = torch.autograd.grad(nm.mixture_inverse_logit_cdf(*ts), ts,
                              torch.tensor(gx))
    for g, r in zip(got, ref):
        g = g.numpy()
        near = np.abs(g - r) <= 1e-3 * np.abs(r) + 1e-4 * np.abs(r).max()
        assert near.mean() >= 0.9


# -- the shapes the SetTransformer kernels take ------------------------------

@pytest.mark.parametrize("case", ["mask", "cond", "set129", "wide_bf16"])
def test_kernels_refuse_what_they_do_not_take(case):
    """``ft.supported``, which the card's wrappers ask before a launch and
    raise on when it refuses (shapes only, so it runs here on CPU
    tensors), refuses a key mask of another shape than the sets' (the
    kernels take one of their shape), a condition, a set above 128 and a
    bf16 width above 256, and takes the same call without them."""
    hidden = 288 if case == "wide_bf16" else 32
    set_size = 129 if case == "set129" else 16
    x = torch.randn(3, set_size, 1)
    cond = torch.randn(3, set_size, 1) if case == "cond" else None
    mask = torch.ones(3, set_size - 1) if case == "mask" else None
    assert not ft.supported(x, cond, mask, hidden, 4, 2, torch.bfloat16)
    if case in ("mask", "cond"):
        assert ft.supported(x, None, None, hidden, 4, 2, torch.bfloat16)


def test_kernels_take_the_flagship_and_the_vardeq_shapes():
    """The flagship's net (in 4, out 104) and the vardeq main flow's (in 1,
    out 26), in bf16 and fp32: the forward takes them and a tile of the
    backward fits in shared memory."""
    for in_dim, out in ((4, 104), (1, 26)):
        x = torch.zeros(1024, 16, in_dim)
        for cd in (torch.bfloat16, torch.float32):
            assert ft.supported(x, None, None, 96, 4, 2, cd)
            smem = ft.bwd_layout(cd, 16, in_dim, 96, 192, out, 4, 2)[1]
            assert smem <= ft.MAX_SMEM
    assert not ft.supported(torch.zeros(2, 16, 1), None, None, 96, 5, 2,
                            torch.bfloat16)
