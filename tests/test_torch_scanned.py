"""The port's ScannedBlocks against the JAX package's, on the CPU.

A depth-2 stack of two-parity blocks (ActNorm, InvertibleLinear, a
SetTransformer MixtureCDFCoupling, SoftClamp; hidden 16, D = 4) with the
reference's weights carried across by ``convert.from_jax_params``: forward,
inverse and data init with and without a mask, gradients with remat, and a
4-layer scanned set task end to end.  The tolerance is 1e-4 where a
coupling's root-find or its mixture sums are inside, as for the single
layers (``tests/test_torch_slice.py``).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from categoricalnf_tpu import flows as jflows
from categoricalnf_tpu.networks.transformer import \
    SetTransformer as JaxSetTransformer
from categoricalnf_tpu.tasks.set_modeling import \
    SetShufflingTask as JaxSetShufflingTask
from categoricalnf_tpu_torch import flows as tflows
from categoricalnf_tpu_torch.convert import from_jax_params
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.tasks import SetShufflingTask

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

B, T, D, K, HIDDEN, DEPTH = 4, 5, 4, 3, 16, 2
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_block():
    net = JaxSetTransformer(hidden_dim=HIDDEN, num_heads=4, num_layers=2,
                            compute_dtype="float32")

    def sub(parity):
        return (jflows.ActNorm(), jflows.InvertibleLinear(),
                jflows.MixtureCDFCoupling(net=net, parity=parity,
                                          num_mixtures=K),
                jflows.SoftClamp())
    return sub(0) + sub(1)


def _port_block():
    def sub(parity):
        net = SetTransformer(D, D * (2 + 3 * K), hidden_dim=HIDDEN,
                             num_heads=4, compute_dtype="float32")
        return [tflows.ActNorm(D), tflows.InvertibleLinear(D),
                tflows.MixtureCDFCoupling(net, D, parity=parity,
                                          num_mixtures=K),
                tflows.SoftClamp()]
    return sub(0) + sub(1)


def _pair(remat=False, seed=0):
    """The reference's ScannedBlocks with random ActNorms and coupling
    output layers (zero ones make every coupling the identity), and the
    port's, loaded through ``from_jax_params``."""
    jscan = jflows.ScannedBlocks(block=_jax_block(), depth=DEPTH)
    params = list(_np(jax.jit(jscan.init, static_argnums=1)(
        jax.random.PRNGKey(seed), D)))
    r = np.random.default_rng(seed + 1)
    for li in (0, 4):
        params[li] = {k: (r.standard_normal((DEPTH, D)) * 0.3).astype(
            np.float32) for k in ("bias", "log_scale")}
    for li in (2, 6):
        out = params[li]["net"]["out"]
        for k in ("w", "b"):
            out[k] = (r.standard_normal(out[k].shape) * 0.1).astype(
                np.float32)
    params = tuple(params)
    tscan = tflows.ScannedBlocks([_port_block() for _ in range(DEPTH)],
                                 remat=remat)
    holder = SimpleNamespace(model=nn.ModuleDict(
        {"flow": tflows.FlowModel([tscan])}))
    holder.model.load_state_dict(
        from_jax_params(holder, {"encoding": {}, "flow": (params,)}))
    return jscan, params, tscan


def _mask(masked):
    if not masked:
        return None
    return (np.arange(T)[None, :] < np.array([[5], [4], [3], [2]])).astype(
        np.float32)


def _z(seed, scale=1.5):
    return (np.random.default_rng(seed).standard_normal((B, T, D))
            * scale).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_scanned_matches_reference(masked):
    """forward and inverse, z and ldj, to 1e-4."""
    jscan, params, tscan = _pair()
    mask = _mask(masked)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    z = _z(2)
    zero = np.zeros(B, np.float32)
    for name in ("forward", "inverse"):
        jz, jl = jax.jit(getattr(jscan, name))(params, jnp.asarray(z), zero,
                                                mask=jm)
        with torch.no_grad():
            tz, tl = getattr(tscan, name)(torch.tensor(z), torch.tensor(zero),
                                          mask=tm)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_scanned_data_init_matches_reference(masked):
    """Block by block: each depth's ActNorms take the statistics they see,
    and the calibrated stack's output agrees with the reference's."""
    jscan, params, tscan = _pair()
    mask = _mask(masked)
    z = _z(3) * 2.0 + 1.0
    jp, jz = jax.jit(jscan.data_init)(
        params, jnp.asarray(z),
        mask=None if mask is None else jnp.asarray(mask))
    tz = tscan.data_init(torch.tensor(z),
                         mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=TOL, atol=TOL)
    for d in range(DEPTH):
        for li in (0, 4):
            for k in ("bias", "log_scale"):
                np.testing.assert_allclose(
                    getattr(tscan.blocks[d][li], k).detach().numpy(),
                    np.asarray(jp[li][k][d]), rtol=TOL, atol=TOL)


def test_scanned_inverts_its_forward():
    _, _, tscan = _pair()
    z = torch.tensor(_z(4))
    with torch.no_grad():
        zf, ldj = tscan(z, torch.zeros(B))
        zr, ldj_r = tscan.inverse(zf, ldj)
    torch.testing.assert_close(zr, z, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(ldj_r, torch.zeros(B), rtol=0, atol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_remat_gradients_match_nonremat(masked):
    """Recomputing each block in the backward pass changes memory, not the
    loss or any gradient (the CPU arithmetic is deterministic: equal)."""
    mask = _mask(masked)
    tm = None if mask is None else torch.tensor(mask)
    z = torch.tensor(_z(5))
    out = []
    for remat in (False, True):
        _, _, tscan = _pair(remat=remat)
        zz, ldj = tscan(z.clone().requires_grad_(True), torch.zeros(B),
                        mask=tm)
        loss = (zz ** 2).sum() + ldj.sum()
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in
                                    tscan.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    assert all(g is not None for g in g0.values())
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_scanned_blocks_refuse_mixed_blocks():
    with pytest.raises(ValueError, match="one layer"):
        tflows.ScannedBlocks([[tflows.ActNorm(D)], [tflows.SoftClamp()]])


SET_TINY = dict(set_size=6, batch_size=8, num_layers=4, hidden_dim=16,
                num_mixtures=3, encoding_dim=2, compute_dtype="float32")


@pytest.mark.parametrize("remat", [False, True])
def test_scanned_set_task_matches_reference(remat):
    """A 4-layer set task scanned (scan_blocks=True) in both frameworks,
    the reference's data-initialised weights carried across: the ELBO's
    parts and a sample with shared noise to 1e-4; remat reaches the
    stack."""
    jtask = JaxSetShufflingTask(**SET_TINY, scan_blocks=True, remat=remat)
    ttask = SetShufflingTask(**SET_TINY, scan_blocks=True, remat=remat,
                             device="cpu")
    (scan,) = ttask.model.flow.layers
    assert isinstance(scan, tflows.ScannedBlocks) and scan.remat == remat
    n, s = SET_TINY["batch_size"], SET_TINY["set_size"]
    x = np.argsort(np.random.default_rng(7).random((n, s)), axis=1)
    params = _np(jax.jit(jtask.data_init)(
        jax.jit(jtask.init_params)(jax.random.PRNGKey(0)),
        {"x": jnp.asarray(x)}, jax.random.PRNGKey(1)))
    r = np.random.default_rng(2)
    for li in (2, 6):
        w = params["flow"][0][li]["net"]["out"]["w"]
        params["flow"][0][li]["net"]["out"]["w"] = (
            r.standard_normal(w.shape) * 0.1).astype(np.float32)
    ttask.model.load_state_dict(from_jax_params(ttask, params))

    key = jax.random.PRNGKey(9)
    parts = jax.jit(jtask.model.elbo)(params, jnp.asarray(x), key)
    u = np.asarray(jax.random.uniform(key, (n, s, 2), jnp.float32,
                                      minval=1e-6, maxval=1.0 - 1e-6))
    with torch.no_grad():
        tparts = ttask.model.elbo(torch.tensor(x), noise=torch.tensor(u))
    for k in ("log_pz", "log_dec", "log_q", "elbo"):
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(parts[k]),
                                   rtol=TOL, atol=TOL)

    zk = jnp.log(u) - jnp.log1p(-u)
    jz, _ = jax.jit(jtask.model.flow.inverse)(params["flow"], zk)
    with torch.no_grad():
        tz = ttask.model.flow.sample((n, s, 2), noise=torch.tensor(u))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=TOL, atol=TOL)
    # a training step's gradient flows through the (rematerialised) stack
    ttask.loss({"x": x}, 1.0, noise=torch.tensor(u)).backward()
    assert all(p.grad is not None for p in ttask.model.parameters())


def test_unrolled_set_stack_keeps_its_names():
    """At 8 layers the set stack stays unrolled (``scan_blocks=None``): the
    reference's unrolled tree carries across name for name, so the
    flagship's parameter names and checkpoints are those of before."""
    args = {**SET_TINY, "num_layers": 8}
    jtask = JaxSetShufflingTask(**args)
    ttask = SetShufflingTask(**args, device="cpu")
    params = _np(jtask.init_params(jax.random.PRNGKey(0)))
    assert len(params["flow"]) == 32
    state = from_jax_params(ttask, params)
    assert set(state) == set(ttask.model.state_dict())
    assert not any(k.startswith("flow.layers.0.blocks.") for k in state)
    assert "flow.layers.28.bias" in state
