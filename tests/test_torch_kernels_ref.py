"""The port's SetTransformer (the fused kernel's plain version) against the
JAX package's ``SetTransformer.apply`` and ``fused_set_transformer`` (Pallas
interpret mode off the TPU), on shared weights and inputs from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.networks.transformer import \
    SetTransformer as JaxSetTransformer
from categoricalnf_tpu.ops.pallas import fused_transformer as jft
from categoricalnf_tpu_torch.convert import flatten_tree
from categoricalnf_tpu_torch.networks import SetTransformer, dense
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

B, S, IN, H, HEADS = 8, 4, 4, 24, 4
OUT = IN * (2 + 3 * 3)


def _nets(compute_dtype):
    jnet = JaxSetTransformer(hidden_dim=H, num_heads=HEADS, num_layers=2,
                             compute_dtype=compute_dtype)
    params = jax.tree.map(np.asarray,
                          jnet.init(jax.random.PRNGKey(0), IN, OUT))
    r = np.random.default_rng(1)
    # a zero output layer would make y == bias: randomize it
    params["out"]["w"] = (r.standard_normal((H, OUT)) * 0.1).astype(
        np.float32)
    params["out"]["b"] = (r.standard_normal(OUT) * 0.1).astype(np.float32)
    tnet = SetTransformer(IN, OUT, hidden_dim=H, num_heads=HEADS,
                          compute_dtype=compute_dtype)
    tnet.load_state_dict(flatten_tree(params))
    x = np.random.default_rng(2).standard_normal((B, S, IN)).astype(
        np.float32)
    return jnet, params, tnet, x


def _port(tnet, x):
    with torch.no_grad():
        return tnet(torch.tensor(x)).float().numpy()


def _jax_fused(jnet, params, x):
    return jft.fused_set_transformer(
        params, jnp.asarray(x), hidden_dim=H, num_heads=HEADS, num_layers=2,
        mlp_ratio=2, compute_dtype=jnet.compute_dtype, out_dim=OUT)


def test_fp32_matches_apply_and_pallas():
    """(c) fp32: 1e-5 against the XLA path and the Pallas kernel."""
    jnet, params, tnet, x = _nets("float32")
    y = _port(tnet, x)
    np.testing.assert_allclose(y, np.asarray(jnet.apply(params, x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, np.asarray(_jax_fused(jnet, params, x)),
                               rtol=1e-5, atol=1e-5)


def _frac_off(y, ref):
    err = np.abs(y - ref)
    return float((err > 0.05 * np.maximum(np.abs(ref), 1.0)).mean())


def test_bf16_within_loose_bound():
    """(c) bf16: fewer than 2% of elements off by more than 5% (the bound
    the reference's tests hold its own bf16 kernel to), since bf16
    roundings can flip on fp32 summation-order noise."""
    jnet, params, tnet, x = _nets("bfloat16")
    y = _port(tnet, x)
    assert _frac_off(y, np.asarray(jnet.apply(params, x), np.float32)) < 0.02
    assert _frac_off(y, np.asarray(_jax_fused(jnet, params, x),
                                   np.float32)) < 0.02


def test_masked_attention_matches_apply():
    """The unfused path's key mask (the kernel does not take masks)."""
    jnet, params, tnet, x = _nets("float32")
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0
    want = np.asarray(jnet.apply(params, x, mask=jnp.asarray(mask)))
    with torch.no_grad():
        y = tnet(torch.tensor(x), mask=torch.tensor(mask)).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_dense_rounds_after_bias(cd):
    """dense: compute-dtype operands, fp32 sum and bias, one rounding."""
    from categoricalnf_tpu.networks.common import dense as jdense
    r = np.random.default_rng(3)
    w = r.standard_normal((24, 7)).astype(np.float32)
    b = r.standard_normal(7).astype(np.float32)
    x = r.standard_normal((5, 24)).astype(np.float32)
    want = np.asarray(jdense({"w": w, "b": b}, x, jnp.dtype(cd)), np.float32)
    got = dense(torch.tensor(w), torch.tensor(b), torch.tensor(x),
                getattr(torch, cd)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_flatten_params_layout_matches_reference():
    jnet, params, tnet, _ = _nets("float32")
    want = jft.flatten_params(params, 2)
    got = ft.flatten_params(tnet)
    assert len(got) == len(want) == ft.NUM_W
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


def test_supported_rule():
    x = torch.zeros(B, 16, IN)
    assert ft.supported(x, None, None, 96, 4)
    # a key mask of the sets' shape is taken, one of another shape not
    assert ft.supported(x, None, torch.ones(B, 16), 96, 4)
    assert not ft.supported(x, None, torch.ones(B, 15), 96, 4)
    assert not ft.supported(x, torch.ones(B, 16, 2), None, 96, 4)
    assert not ft.supported(x, None, None, 96, 5)
    # sets up to 128 rows (the reference's largest Pallas tile of whole
    # sets), not above
    assert ft.supported(torch.zeros(B, 128, IN), None, None, 96, 4)
    assert not ft.supported(torch.zeros(B, 129, IN), None, None, 96, 4)
    # the flagship tile: 32 rows of h, LN buffer and qkv in fp32, rows 4
    # mod 8 floats wide, and 8 floats of slack
    assert ft.smem_bytes(16, 4, 96, 192) == 4 * (32 * (2 * 100 + 292) + 8)


def test_fused_net_takes_plain_path_on_cpu():
    """A CPU tensor runs the unfused path (no launch); the kernel's
    wrapper refuses weights that are not on the card."""
    jnet, params, tnet, x = _nets("float32")
    before = dict(ft.LAUNCHES)
    np.testing.assert_allclose(_port(tnet, x),
                               np.asarray(jnet.apply(params, x)),
                               rtol=1e-5, atol=1e-5)
    assert ft.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        ft.PackedWeights(ft.flatten_params(tnet), torch.float32)
