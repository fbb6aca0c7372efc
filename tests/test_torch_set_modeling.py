"""The port's set-summation task and the set tasks' other encodings against
the JAX package, on the CPU; then the post-hoc CLIs and the serving of a
set-summation run.

The counting DP and the optimum, the rejection sampler (bit for bit
against the reference's numpy path), and a tiny ``SetSummationTask`` (sets
of 6, K = 5, batch 8, hidden 16, 2 layers) with the mixture and the
dequantization encodings: the loss and every parameter's gradient on the
reference's parameters (``convert.from_jax_params``) and the same uniform
noise.  ``from_jax_params`` on the vardeq, linear-flows and learned-decoder
trees.  The post-hoc CLIs write only into a temporary run directory.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu import flows as jflows
from categoricalnf_tpu.data import native_loader
from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu.tasks import set_modeling as jsm
from categoricalnf_tpu_torch.convert import flatten_tree, from_jax_params
from categoricalnf_tpu_torch.data import corpus as tcorpus
from categoricalnf_tpu_torch.ops import dispatch as tdispatch
from categoricalnf_tpu_torch.ops import numerics as tnm
from categoricalnf_tpu_torch.tasks import set_modeling as tsm

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

B, S, K = 8, 6, 5
TINY = dict(set_size=S, num_categories=K, batch_size=B, num_layers=2,
            hidden_dim=16, num_mixtures=3, encoding_dim=2, vardeq_hidden=16,
            eval_batches_count=1, compute_dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("length,num_cat,target",
                         [(16, 10, 88), (6, 5, 18), (3, 4, 2), (5, 3, 20),
                          (1, 7, 7)])
def test_count_and_optimum_match_reference(length, num_cat, target):
    """The DP's count equals the reference's (exact Python ints); at the
    default target of 16 values in 1..10 the optimum is log2(count)/16."""
    want = jsm._count_sum_sequences(length, num_cat, target)
    assert tsm._count_sum_sequences(length, num_cat, target) == want
    if (length, num_cat) == (16, 10):
        task = tsm.SetSummationTask(**{**TINY, "set_size": 16,
                                       "num_categories": 10},
                                    device="cpu")
        assert task.target_sum == target
        assert task.analytic_optimum_bpd() == pytest.approx(
            np.log2(want) / 16, rel=1e-12)


def test_sampler_matches_reference_numpy_path(monkeypatch):
    """With no native generator in either package (the reference's
    ``get_lib`` and the port's ``corpus.library`` cached as None) the
    reference's batches are the port's, bit for bit; each sums to the
    target once shifted back to 1..K."""
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "_TRIED", True)
    monkeypatch.setattr(tcorpus, "_lib", None)
    monkeypatch.setattr(tcorpus, "_tried", True)
    jtask = jsm.SetSummationTask(**TINY)
    ttask = tsm.SetSummationTask(**TINY, device="cpu")
    for seed in (0, 1):
        want = jtask._gen(np.random.default_rng(seed), 37)
        got = ttask._gen(np.random.default_rng(seed), 37)
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < K
        assert ((got + 1).sum(axis=1) == ttask.target_sum).all()
    np.testing.assert_array_equal(ttask.eval_batches()[0]["x"],
                                  jtask.eval_batches()[0]["x"])


@functools.lru_cache(maxsize=None)
def _jax_params(encoding):
    """The reference's data-initialised tiny task, every coupling's zero
    output layer (and the encoder flow's) randomised."""
    jtask = jsm.SetSummationTask(**TINY, encoding_name=encoding)
    x = jtask._gen(np.random.default_rng(7), B)
    params = _np(jax.jit(jtask.data_init)(
        jax.jit(jtask.init_params)(jax.random.PRNGKey(0)),
        {"x": jnp.asarray(x)}, jax.random.PRNGKey(1)))
    r = np.random.default_rng(3)

    def randomize(layers, model_layers):
        for p, layer in zip(layers, model_layers):
            if isinstance(layer, jflows.MixtureCDFCoupling):
                out = (p["net"]["out"] if isinstance(p["net"], dict)
                       else p["net"][-1])
                out["w"] = (r.standard_normal(out["w"].shape)
                            * 0.05).astype(np.float32)
            elif "fc2" in p:
                p["fc2"]["w"] = (r.standard_normal(p["fc2"]["w"].shape)
                                 * 0.05).astype(np.float32)

    randomize(params["flow"], jtask.model.flow.layers)
    if encoding == "vardeq":
        randomize(params["encoding"]["flow"],
                  jtask.model.encoding.flow.layers)
    return jtask, params, x


def _pair(encoding):
    jtask, params, x = _jax_params(encoding)
    ttask = tsm.SetSummationTask(**TINY, encoding_name=encoding,
                                 device="cpu")
    ttask.model.load_state_dict(from_jax_params(ttask, params))
    return jtask, params, ttask, x


def _jax_loss_and_grad(jtask, params, x, u, monkeypatch):
    """``jax.value_and_grad`` of the reference's loss, its encoder's
    uniform draw replaced by ``u``; gradients named as the port's."""
    def sample(rng, shape, mean=0.0, log_scale=0.0):
        logit_u = jnp.log(u) - jnp.log1p(-u)
        return jnp.float32(mean) + jnp.exp(jnp.float32(log_scale)) * logit_u
    monkeypatch.setattr(jnm, "logistic_sample", sample)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss(p, {"x": jnp.asarray(x)},
                             jax.random.PRNGKey(5), 0.8)))(params)
    grads = _np(grads)
    enc = dict(grads["encoding"])
    flat = {**flatten_tree(list(enc.pop("flow", ())),
                           "encoding.flow.layers."),
            **flatten_tree(enc, "encoding."),
            **flatten_tree(list(grads["flow"]), "flow.layers.")}
    return float(loss), {k: v.numpy() for k, v in flat.items()}


def _implicit_inverses(monkeypatch):
    """Both frameworks' inverse differentiated by the implicit rule, the
    card's (#1'): the reference's by a ``jax.custom_vjp`` around its loop,
    the port's CPU one by ``numerics.ImplicitInverse``."""
    loop = jnm.mixture_inverse_logit_cdf

    @jax.custom_vjp
    def inverse(y, pi, mu, ls):
        return loop(y, pi, mu, ls)

    def fwd(y, pi, mu, ls):
        x = loop(y, pi, mu, ls)
        return x, (x, pi, mu, ls)

    def bwd(res, gx):
        x, pi, mu, ls = res
        (_, ldj), pull = jax.vjp(
            lambda *p: jnm.mixture_logit_cdf_and_ldj(x, *p), pi, mu, ls)
        gy = gx * jnp.exp(-ldj)
        return (gy, *pull((-gy, jnp.zeros_like(gy))))

    inverse.defvjp(fwd, bwd)
    monkeypatch.setattr(jnm, "mixture_inverse_logit_cdf", inverse)
    monkeypatch.setattr(tdispatch, "mixture_inverse",
                        tnm.ImplicitInverse.apply)


@pytest.mark.parametrize("encoding", ["mixture", "vardeq"])
def test_loss_and_gradients_match_reference(encoding, monkeypatch):
    """The loss (beta 0.8) within 1e-5 relative and each parameter's
    gradient within 1e-3 of its norm, the dequantization encoder's too:
    its parameters reach the loss through the inverse of its flow, which
    both frameworks differentiate here by the implicit rule
    (``_implicit_inverses``; through their loops the two derivatives agree
    only where both loops take the same clipped steps, see
    test_torch_encodings).  The dequantized z within 1e-4."""
    _implicit_inverses(monkeypatch)
    jtask, params, ttask, x = _pair(encoding)
    dim = ttask.model.encoding.dim
    u = np.random.default_rng(11).uniform(1e-6, 1 - 1e-6,
                                          (B, S, dim)).astype(np.float32)
    jloss, jgrads = _jax_loss_and_grad(jtask, params, x, u, monkeypatch)
    tloss = ttask.loss({"x": x}, 0.8, noise=torch.tensor(u))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), jloss, rtol=1e-5)
    tgrads = {k: p.grad for k, p in ttask.model.named_parameters()}
    assert set(tgrads) <= set(jgrads)
    for k in set(jgrads) - set(tgrads):  # perm and sign_s: buffers
        assert not jgrads[k].any(), k
    for k, g in tgrads.items():
        err = np.linalg.norm(g.numpy() - jgrads[k])
        assert err <= 1e-3 * np.linalg.norm(jgrads[k]) + 1e-6, k
    if encoding == "vardeq":
        z, _ = jtask.model.encoding.encode(params["encoding"],
                                           jnp.asarray(x), None)
        with torch.no_grad():
            tz, _ = ttask.model.encoding.encode(torch.tensor(x),
                                                noise=torch.tensor(u))
        np.testing.assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-4,
                                   atol=1e-4)


def test_eval_bpd_matches_reference_for_vardeq():
    """The fp32 IS bits/var of 4 chains on shared noise within 1e-4, and
    above the optimum."""
    jtask, params, ttask, x = _pair("vardeq")
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, 4)
    noise = np.stack([np.asarray(jax.random.uniform(
        k, (B, S, 1), jnp.float32, minval=1e-6, maxval=1.0 - 1e-6))
        for k in keys])
    want = np.asarray(jax.jit(jtask.eval_step, static_argnums=3)(
        params, {"x": jnp.asarray(x)}, key, 4))
    got = ttask.eval_step({"x": x}, 4, noise=torch.tensor(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got > ttask.analytic_optimum_bpd()).all()


@pytest.mark.parametrize("task,kw", [
    ("shuffling", dict(encoding_name="linear_flows")),
    ("shuffling", dict(encoding_name="vardeq", vardeq_blocks=1)),
    ("shuffling", dict(decoder="mlp")),
    ("shuffling", dict(decoder="linear")),
    ("summation", dict(encoding_name="vardeq"))],
    ids=["linear_flows", "vardeq", "decoder-mlp", "decoder-linear",
         "summation-vardeq"])
def test_from_jax_params_carries_the_encodings(task, kw):
    """Every parameter of the reference's tree lands on the port's name of
    it with its shape; a tree without the encoder's flow (or decoder) is
    refused."""
    if task == "shuffling":
        base = {k: v for k, v in TINY.items() if k != "num_categories"}
        jtask = jsm.SetShufflingTask(**base, **kw)
        ttask = tsm.SetShufflingTask(**base, **kw, device="cpu")
    else:
        jtask = jsm.SetSummationTask(**TINY, **kw)
        ttask = tsm.SetSummationTask(**TINY, **kw, device="cpu")
    params = _np(jax.jit(jtask.init_params)(jax.random.PRNGKey(2)))
    flat = from_jax_params(ttask, params)
    ttask.model.load_state_dict(flat)
    for name, v in ttask.model.state_dict().items():
        assert torch.equal(v, flat[name])
    if "flow" in params["encoding"]:
        del params["encoding"]["flow"]
    else:
        del params["encoding"]["decoder"]
    with pytest.raises(ValueError, match="differ"):
        from_jax_params(ttask, params)


def _trained_run(tmp_path, encoding="vardeq"):
    """A set-summation run of 4 steps on the CPU, written by the CLI."""
    from categoricalnf_tpu_torch.experiments import set_summation
    out = str(tmp_path / "run")
    final = set_summation.main([
        "--device", "cpu", "--out_dir", out, "--num_steps", "4",
        "--eval_every", "2", "--eval_samples", "2", "--log_every", "2",
        "--batch_size", "8", "--set_size", "6", "--num_categories", "5",
        "--num_layers", "2", "--hidden_dim", "16", "--num_mixtures", "3",
        "--encoding", encoding, "--vardeq_hidden", "16",
        "--compute_dtype", "float32"])
    assert np.isfinite(final["best_bpd"]) and "sum_validity" in final
    return out


def test_posthoc_clis_on_a_cpu_run(tmp_path):
    """The training CLI writes a run; ``sample_eval`` writes its sweep (and
    the step-named copy) into that run; ``eval_bpd`` appends one posthoc
    line to its metrics and, with ``--no_write``, none."""
    from categoricalnf_tpu_torch.experiments import eval_bpd, sample_eval
    out = _trained_run(tmp_path)
    rows = sample_eval.main(["--run", out, "--device", "cpu",
                             "--temperatures", "0.5,1.0",
                             "--num_samples", "16"])
    assert [r["temperature"] for r in rows] == [0.5, 1.0]
    assert all(0.0 <= r["sum_validity"] <= 1.0
               and r["metric_num_samples"] == 16.0 for r in rows)
    with open(os.path.join(out, "temperature_sweep.json")) as f:
        assert json.load(f) == rows
    step = rows[0]["step"]
    assert os.path.exists(os.path.join(
        out, f"temperature_sweep_{step}_16.json"))
    metrics = os.path.join(out, "metrics.jsonl")
    before = open(metrics).read().splitlines()
    res = eval_bpd.main(["--run", out, "--device", "cpu", "--num_samples",
                         "4", "--split", "val"])
    after = open(metrics).read().splitlines()
    assert after[:-1] == before and json.loads(after[-1]) == res
    assert res["prefix"] == "posthoc_val" and res["num_batches"] == 4
    assert res["gap_to_optimum"] > 0 and not res["partial"]
    eval_bpd.main(["--run", out, "--device", "cpu", "--num_samples", "2",
                   "--no_write", "--max_batches", "1"])
    assert open(metrics).read().splitlines() == after


def test_serve_a_set_summation_run(tmp_path):
    """/sample answers lists of ints in 0..K-1 as set shuffling's do, and
    /sample_metrics the share of sums that hit the target."""
    from categoricalnf_tpu_torch.serve import RunServer
    out = _trained_run(tmp_path, "mixture")
    server = RunServer(out, device="cpu")
    assert server.health()["task"] == "set_summation"
    samples = np.asarray(server.sample(3, 1.0))
    assert samples.shape == (3, S) and samples.dtype.kind == "i"
    assert samples.min() >= 0 and samples.max() < K
    m = server.sample_metrics(32, 0.8)
    assert m["metric_num_samples"] == 32.0 and 0 <= m["sum_validity"] <= 1
