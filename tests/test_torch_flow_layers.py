"""The port's ``ExtActNorm`` and ``ReverseChannels`` against the JAX
package's, on the CPU: forward, inverse and log-det on the same inputs,
with and without a mask, a round trip (as ``tests/test_flows.py`` does for
the reference), and ``convert.from_jax_params`` over their empty
parameter dicts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from categoricalnf_tpu import flows as jflows
from categoricalnf_tpu_torch import flows as tflows
from categoricalnf_tpu_torch.convert import from_jax_params

# one intra-op thread: pytest-xdist runs six workers at once
torch.set_num_threads(1)

B, T, D = 8, 6, 4


def _inputs(seed: int = 0):
    r = np.random.default_rng(seed)
    z = (r.standard_normal((B, T, D)) * 1.5).astype(np.float32)
    # raw log-scales far enough out that the tanh cap bends them
    cond = np.concatenate([r.standard_normal((B, T, D)),
                           r.standard_normal((B, T, D)) * 4.0],
                          axis=-1).astype(np.float32)
    ldj = r.standard_normal(B).astype(np.float32)
    lengths = np.array([T, T, T - 1, T - 2, 3, 2, 1, T])
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return z, cond, ldj, mask


LAYERS = {"ext_actnorm": (jflows.ExtActNorm, tflows.ExtActNorm),
          "reverse_channels": (jflows.ReverseChannels,
                               tflows.ReverseChannels)}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name, masked):
    """forward and inverse: z and the running log-det within 1e-6 of the
    reference's on the same z, cond, ldj and mask; then the port's round
    trip gives z and the starting log-det back."""
    z, cond, ldj, mask = _inputs()
    mask = mask if masked else None
    jlayer, tlayer = LAYERS[name][0](), LAYERS[name][1]()
    params = jlayer.init(jax.random.PRNGKey(0), D, 2 * D)
    assert params == {} and not list(tlayer.parameters())
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    for direction in ("forward", "inverse"):
        jz, jl = getattr(jlayer, direction)(params, jnp.asarray(z),
                                            jnp.asarray(ldj),
                                            cond=jnp.asarray(cond), mask=jm)
        tz, tl = getattr(tlayer, direction)(
            torch.from_numpy(z), torch.from_numpy(ldj),
            cond=torch.from_numpy(cond), mask=tm)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                                   atol=1e-5)
    zf, lf = tlayer(torch.from_numpy(z), torch.from_numpy(ldj),
                    cond=torch.from_numpy(cond), mask=tm)
    zr, lr = tlayer.inverse(zf, lf, cond=torch.from_numpy(cond), mask=tm)
    np.testing.assert_allclose(zr.numpy(), z, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lr.numpy(), ldj, atol=1e-5)


def test_ext_actnorm_log_det_is_its_masked_log_scale():
    """The log-det of ExtActNorm is the sum over live positions of its
    capped log-scale; the masked positions add nothing; ReverseChannels
    adds 0."""
    z, cond, ldj, mask = _inputs(1)
    layer = tflows.ExtActNorm(scale_cap=3.0)
    _, l = layer(torch.from_numpy(z), torch.zeros(B),
                 cond=torch.from_numpy(cond), mask=torch.from_numpy(mask))
    ls = 3.0 * np.tanh(cond[..., D:] / 3.0)
    np.testing.assert_allclose(l.numpy(), (ls * mask[..., None]).sum((1, 2)),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(ls).max() < 3.0
    zr, l0 = tflows.ReverseChannels()(torch.from_numpy(z), torch.zeros(B))
    np.testing.assert_array_equal(zr.numpy(), z[..., ::-1])
    assert (l0 == 0).all()


def test_from_jax_params_accepts_their_empty_dicts():
    """A flow with both layers among parametrised ones: the reference's
    tree carries ``{}`` for each, and the converted state dict loads into
    the port's model with every other layer's parameters in place."""
    jflow = jflows.FlowModel(layers=(jflows.ActNorm(), jflows.ReverseChannels(),
                                     jflows.ExtActNorm(),
                                     jflows.InvertibleLinear()))
    params = jax.tree.map(np.asarray,
                          jflow.init(jax.random.PRNGKey(0), D, 2 * D))
    assert params[1] == {} and params[2] == {}
    model = torch.nn.Module()
    model.flow = tflows.FlowModel([tflows.ActNorm(D), tflows.ReverseChannels(),
                                   tflows.ExtActNorm(),
                                   tflows.InvertibleLinear(D)])
    state = from_jax_params(SimpleNamespace(model=model),
                            {"encoding": {}, "flow": params})
    model.load_state_dict(state)
    np.testing.assert_array_equal(model.flow.layers[3].lower.detach().numpy(),
                                  params[3]["lower"])
