"""Sets of 33 to 128 rows, on the CPU.

The reference runs sets of 64 and 128 through its fused Pallas kernels
(tiles of whole sets, per-set attention by a block-diagonal bias) and other
sizes through XLA; the port runs every size up to 128 through its fused
kernels on the card (``--set_size`` of the set CLIs).  Here the kernels'
plain version, ``SetTransformer.plain_forward`` (and autograd through it),
is held against the reference's fused kernel in interpret mode at sets of
64 and 128 and against its XLA SetTransformer at 48 and 100; the set task
at set_size 64 against the reference's (batches, one ELBO, and the fp32
loss and gradients of a train step); the kernels' layout mirrors
(whole-set tiles, clusters of 2 and 4 blocks, the fp32 train step's pair
included) at sets of 33 to 128 and their refusal of 129 (ROADMAP B16).  The
kernels themselves run in ``tests/test_torch_cuda.py`` on the card.

Tolerances: fp32 within TOL = 1e-4 of the reference's largest magnitude,
as ``tests/test_torch_key_mask.py``; the ELBO's parts within 1e-4, as
``tests/test_torch_slice.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu import flows as jflows
from categoricalnf_tpu.networks.transformer import \
    SetTransformer as JaxSetTransformer
from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu.ops.pallas import fused_transformer as jft
from categoricalnf_tpu.tasks.set_modeling import \
    SetShufflingTask as JaxSetShufflingTask
from categoricalnf_tpu_torch.convert import flatten_tree, from_jax_params
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
from categoricalnf_tpu_torch.tasks import SetShufflingTask

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

TOL = 1e-4
HIDDEN, HEADS, IN, OUT = 16, 4, 3, 10
BF16, F32 = torch.bfloat16, torch.float32


def _pair(s, seed, hidden=HIDDEN):
    """The reference's fp32 SetTransformer (hidden ``hidden``, 4 heads, 2
    blocks, in 3, out 10, output layer random) and the port's with the same
    weights (``convert.flatten_tree``)."""
    r = np.random.default_rng(seed)
    j = JaxSetTransformer(hidden_dim=hidden, num_heads=HEADS, num_layers=2,
                          compute_dtype="float32")
    params = jax.tree.map(np.asarray, j.init(jax.random.PRNGKey(seed), IN,
                                             OUT))
    params["out"]["w"] = (r.standard_normal(params["out"]["w"].shape)
                          * 0.3).astype(np.float32)
    net = SetTransformer(IN, OUT, hidden_dim=hidden, num_heads=HEADS,
                         compute_dtype="float32")
    net.load_state_dict(flatten_tree(params))
    return j, params, net


def _near(a, b):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=TOL * max(np.abs(b).max(), 1.0))


def _against(jax_fn, s, b, seed):
    """The port's plain path (output, and the gradients of x and of every
    parameter for a random cotangent) against ``jax_fn(params, x)`` and
    ``jax.grad`` of it, on ``b`` sets of ``s``."""
    j, params, net = _pair(s, seed)
    r = np.random.default_rng(seed + 1)
    x = r.standard_normal((b, s, IN)).astype(np.float32)
    g = r.standard_normal((b, s, OUT)).astype(np.float32)
    want_y = np.asarray(jax_fn(params, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jax_fn(p, xx) * g),
                      argnums=(0, 1))(params, jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in flatten_tree(gp).items()}
    xt = torch.tensor(x, requires_grad=True)
    y = net(xt)
    names, params_t = zip(*net.named_parameters())
    grads = torch.autograd.grad(y, [xt, *params_t], torch.tensor(g))
    _near(y.detach().numpy(), want_y)
    _near(grads[0].numpy(), np.asarray(gx))
    assert set(names) == set(want)
    for name, got in zip(names, grads[1:]):
        _near(got.numpy(), want[name].reshape(got.shape))


@pytest.mark.parametrize("s", [64, 128])
def test_plain_path_matches_the_reference_fused_kernel(s):
    """Sets of 64 and 128, which the reference runs through its Pallas
    kernels (interpret mode here, as ``tests/test_fused_transformer.py``
    runs them): the output and every gradient within TOL of the largest
    magnitude."""
    j = JaxSetTransformer(hidden_dim=HIDDEN, num_heads=HEADS, num_layers=2,
                          compute_dtype="float32")
    x = jnp.zeros((2, s, IN))
    assert jft.supported(x, None, None, HIDDEN, HEADS)

    def fused(params, xx):
        return jft.fused_set_transformer(
            params, xx, hidden_dim=HIDDEN, num_heads=HEADS, num_layers=2,
            mlp_ratio=j.mlp_ratio, compute_dtype="float32", out_dim=OUT)

    _against(fused, s, 2, s)


@pytest.mark.parametrize("s", [48, 100])
def test_plain_path_matches_the_reference_xla_path(s):
    """Sets of 48 and 100, which the reference's fused kernel does not take
    (its tiles of 128 rows hold no whole number of them) and it runs
    through XLA: the same rule."""
    j, _, _ = _pair(s, s)
    assert not jft.supported(jnp.zeros((2, s, IN)), None, None, HIDDEN,
                             HEADS)
    _against(j.apply, s, 2, s)


TINY64 = dict(set_size=64, batch_size=4, num_layers=2, hidden_dim=16,
              num_mixtures=3, encoding_dim=2, compute_dtype="float32")


def _set_task_pair():
    """SetShufflingTask at set_size 64 (a tiny width, fp32) in both
    frameworks on the reference's data-initialised weights, the coupling
    output layers random: (reference task, its params, port task, x)."""
    jtask = JaxSetShufflingTask(**TINY64)
    ttask = SetShufflingTask(**TINY64, device="cpu")
    x = jtask._gen(np.random.default_rng(2), 4)
    params = jtask.data_init(jtask.init_params(jax.random.PRNGKey(0)),
                             {"x": jnp.asarray(x)}, jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, params)
    for i, layer in enumerate(jtask.model.flow.layers):
        if isinstance(layer, jflows.MixtureCDFCoupling):
            out = params["flow"][i]["net"]["out"]
            r = np.random.default_rng(10 + i)
            out["w"] = (r.standard_normal(out["w"].shape)
                        * 0.1).astype(np.float32)
    ttask.model.load_state_dict(from_jax_params(ttask, params))
    return jtask, params, ttask, x


def test_set_task_at_64_matches_the_reference():
    """SetShufflingTask at set_size 64 (a tiny width): its batches equal
    the reference's, and one ELBO on the reference's data-initialised
    weights and its encoder noise within 1e-4 (log_pz, log_dec, log_q)."""
    jtask, params, ttask, x = _set_task_pair()
    for seed in (0, 1):
        np.testing.assert_array_equal(
            ttask._gen(np.random.default_rng(seed), 4),
            jtask._gen(np.random.default_rng(seed), 4))
    assert x.shape == (4, 64)
    key = jax.random.PRNGKey(9)
    parts = jax.jit(jtask.model.elbo)(params, jnp.asarray(x), key)
    u = np.asarray(jax.random.uniform(key, (4, 64, 2), jnp.float32,
                                      minval=1e-6, maxval=1.0 - 1e-6))
    with torch.no_grad():
        tparts = ttask.model.elbo(torch.tensor(x), noise=torch.tensor(u))
    for k in ("log_pz", "log_dec", "log_q", "elbo"):
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(parts[k]),
                                   rtol=1e-4, atol=1e-4)
    assert ttask.analytic_optimum_bpd() == pytest.approx(4.6249, abs=1e-4)


def test_set_task_fp32_gradients_at_64_match_the_reference(monkeypatch):
    """The fp32 train step at set_size 64, whose nets the card runs through
    the fp32 pair over clusters: the port's loss (beta 0.8) and every
    parameter's gradient, through the plain path, against
    ``jax.value_and_grad`` of the reference's ``task.loss`` on the same
    weights and encoder noise: the loss to 1e-5 (``tests/
    test_torch_training.py``'s fp32 case), each gradient within TOL of its
    largest magnitude (this file's rule; at sets of 64 the sums run four
    times longer than that case's 8, and rtol 1e-4 alone is not met on a
    few elements near 0.2, 3.7e-5 off)."""
    jtask, params, ttask, x = _set_task_pair()
    u = np.random.default_rng(13).uniform(1e-6, 1 - 1e-6,
                                          (4, 64, 2)).astype(np.float32)

    def sample(rng, shape, mean=0.0, log_scale=0.0):
        logit_u = jnp.log(u) - jnp.log1p(-u)
        return jnp.float32(mean) + jnp.exp(jnp.float32(log_scale)) * logit_u

    monkeypatch.setattr(jnm, "logistic_sample", sample)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss(p, {"x": jnp.asarray(x)},
                             jax.random.PRNGKey(5), 0.8)))(params)
    jgrads = jax.tree.map(np.asarray, jgrads)
    want = {**flatten_tree(jgrads["encoding"], "encoding."),
            **flatten_tree(list(jgrads["flow"]), "flow.layers.")}
    loss = ttask.loss({"x": x}, 0.8, noise=torch.tensor(u))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    got = dict(ttask.model.named_parameters())
    assert set(got) <= set(want)
    for k in set(want) - set(got):  # the reference's untrained buffers
        assert not np.asarray(want[k]).any(), k
    for k, p in got.items():
        _near(p.grad.numpy(), np.asarray(want[k]))


# the flagship's coupling net (in 4, out 104) and the vardeq main flow's
# (in 1, out 26), hidden 96, 4 heads, 2 blocks, MLP 192
NETS = {"flagship": (4, 104), "vardeq": (1, 26)}


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("s", [33, 48, 64, 99, 100, 128])
def test_big_set_layouts_fit(net, s):
    """At sets of 33 to 128 the forward of each dtype takes the call and its
    tile fits, and the bf16 backward's tile fits: in bf16 a whole set where
    it fits one block (up to its 64-row tiles), else ceil(s / 2) rows a
    block of a 2-CTA cluster; #3 fp32 (the 3xTF32 twin) splits a set as the
    fp32 train step's pair does (``fma_tile``), over 2 blocks up to 64 rows
    and 4 above, ceil(s / cluster) rows a block; every block fits; the
    persistent grid of a cluster is even and at most two blocks a set."""
    in_dim, out = NETS[net]
    x = torch.zeros(8, s, in_dim)
    for cd in (BF16, F32):
        assert ft.supported(x, None, None, 96, HEADS, 2, cd)
        tile, smem, cluster = ft.fwd_shape(cd, s, in_dim, 96, 192, HEADS)
        assert smem <= ft.MAX_SMEM
        assert tile == ft.split_rows(s, cluster)
    assert ft.fwd_shape(F32, s, in_dim, 96, 192, HEADS)[2] == (
        2 if s <= 64 else 4)
    assert ft.fwd_shape(F32, s, in_dim, 96, 192, HEADS)[::2] == \
        ft.fma_tile(s)[::2]
    assert ft.fwd_shape(BF16, s, in_dim, 96, 192)[2] == (1 if s <= 64
                                                           else 2)
    tile, smem, in_global, cluster = ft.bwd_layout(
        BF16, s, in_dim, 96, 192, out, HEADS, 2)
    assert smem <= ft.MAX_SMEM and not in_global
    assert cluster == (1 if s <= 64 else 2)
    assert tile == ft.split_rows(s, cluster)
    assert ft.bwd_fits(BF16, s, in_dim, 96, 192, out, HEADS, 2)
    _, _, _, grid = ft.bwd_launch(BF16, s, in_dim, 96, 192, out, HEADS, 2,
                                  1024 * s, 132)
    assert grid % cluster == 0 and grid <= cluster * 1024


def test_bf16_tiles_stay_at_64_rows():
    """The bf16 pair's tiles hold at most 64 rows (four 16-row m-tiles of
    its dense products): a set of 65 goes over a cluster of two, 33 rows a
    block, though its whole-set forward would fit; the backward with its
    residual copies in global memory, a test switch, is refused above 32."""
    assert ft.fwd_shape(BF16, 65, 4, 96, 192)[::2] == (33, 2)
    assert ft.fwd_shape(BF16, 64, 4, 192, 384)[::2] == (64, 1)
    assert ft.fwd_shape(BF16, 128, 4, 192, 384)[::2] == (64, 2)
    assert ft.bwd_layout(BF16, 65, 4, 96, 192, 104, HEADS, 2)[::3] == (33, 2)
    assert ft.bwd_layout(BF16, 64, 4, 96, 192, 104, HEADS, 2,
                         True)[1] > ft.MAX_SMEM


@pytest.mark.parametrize("cd", [BF16, F32])
def test_sets_above_128_are_refused(cd):
    """A set of 129 (ROADMAP B16): the forward refuses it, so the card's
    wrappers raise before a launch; 128 is taken."""
    assert not ft.supported(torch.zeros(2, 129, 4), None, None, 96, HEADS,
                            2, cd)
    assert ft.supported(torch.zeros(2, 128, 4), None, None, 96, HEADS, 2,
                        cd)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("s", [33, 48, 64, 99, 100, 128])
def test_fma_pair_layouts_at_big_sets(net, s):
    """The fp32 train step's pair (#3 fp32 with grad, #4 fp32) at sets of
    33 to 128 on the flagship's and the vardeq nets: a set over a cluster
    of 2 blocks up to 64 rows and of 4 above, ceil(s / cluster) rows a
    block (at most 32, the tile of the sets up to 32), both kernels
    splitting it alike (the backward's recompute rebuilds the forward's
    rows where the forward computed them), each block's shared memory
    within MAX_SMEM (the backward's all of it, no workspace), and a
    persistent grid of whole clusters, at most one a set, from the SMs or
    from the clusters the card says it holds."""
    in_dim, out = NETS[net]
    cluster = 2 if s <= 64 else 4
    tile, smem_fwd, fwd_cluster = ft.fma_fwd_shape(s, in_dim, 96, 192)
    btile, smem, regions, bcluster = ft.bwd_layout(F32, s, in_dim, 96, 192,
                                                   out, HEADS, 2)
    assert (tile, fwd_cluster) == (btile, bcluster) == (-(-s // cluster),
                                                        cluster)
    assert tile <= ft.MAX_SET and tile * (cluster - 1) < s
    assert max(smem_fwd, smem) <= ft.MAX_SMEM and regions == ()
    assert ft.bwd_fits(F32, s, in_dim, 96, 192, out, HEADS, 2)
    for sets, clusters in ((1024, None), (1024, 30), (3, None), (3, 30)):
        grid = ft.bwd_launch(F32, s, in_dim, 96, 192, out, HEADS, 2,
                             sets * s, 132, max_clusters=clusters)[3]
        assert grid % cluster == 0 and 0 < grid <= cluster * sets
        if clusters is not None:
            assert grid == cluster * min(sets, clusters)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_backward_fits_checks_sets_up_to_128_and_names_b16(cd):
    """A differentiable call's check passes at every set of 33 to 128 rows
    (in fp32 the pair over clusters) and raises, naming B16, at 129,
    before any launch; the fp32 train step's pair refuses a width whose
    32-row tile does not fit in shared memory at these sets (120, with no
    workspace layout) by the same check."""
    net = SetTransformer(4, 104, hidden_dim=96, num_heads=HEADS,
                         compute_dtype=cd)
    for s in (33, 48, 64, 65, 99, 100, 128):
        net.check_backward_fits(torch.zeros(2, s, 4))
    with pytest.raises((NotImplementedError, ValueError), match="B16"):
        net.check_backward_fits(torch.zeros(2, 129, 4))
    wide = SetTransformer(4, 104, hidden_dim=120, num_heads=HEADS,
                          compute_dtype=cd)
    wide.check_backward_fits(torch.zeros(2, 32, 4))
    if cd == "float32":
        with pytest.raises(NotImplementedError):
            wide.check_backward_fits(torch.zeros(2, 64, 4))
