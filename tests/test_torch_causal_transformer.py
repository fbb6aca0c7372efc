"""The causal-transformer backbone of the LM flows (``--net transformer``)
against the JAX package, on the CPU: ``CausalTransformer``'s whole-sequence
pass and its KV-cache steps on the reference's weights (carried by
``convert.flatten_tree``), the rollout against the pass and causality in
the port alone, the LM flow's roundtrip, a tiny task's loss, IS bits/char
and sample against the reference's, and the CLI with ``--net transformer``
served from its run.

Tolerances: fp32 within ``TOL`` = 1e-4, as the LSTM's parity tests in
``tests/test_torch_language.py``; bf16 within 2 bf16 ulps at the output's
scale (the frameworks sum the fp32 contractions in another order, so a
rounding to bf16 can flip); the rollout against the pass within 2e-4, as
the reference's own test (``tests/test_language.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.networks.causal_transformer import \
    CausalTransformer as JaxCausalTransformer
from categoricalnf_tpu.tasks import language as jlang
from categoricalnf_tpu_torch import flows as tflows
from categoricalnf_tpu_torch.convert import flatten_tree, from_jax_params
from categoricalnf_tpu_torch.networks import CausalTransformer
from categoricalnf_tpu_torch.tasks import language as tlang

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

TOL = 1e-4
ROLLOUT_TOL = 2e-4
B, T, D, K = 4, 8, 4, 4
TINY = dict(corpus_name="synthetic", seq_len=T, batch_size=B,
            encoding_dim=D, num_layers=1, hidden_dim=16, lstm_layers=2,
            num_mixtures=K, eval_batches_count=1, compute_dtype="float32",
            prior="hmm", prior_states=5, net="transformer")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16_tol(want):
    """2 bf16 ulps at the output's scale."""
    return 2.0 ** -6 * float(np.abs(want).max())


def _random_head(params, r, scale=0.3):
    for k in ("w", "b"):
        params["out"][k] = (r.standard_normal(params["out"][k].shape)
                            * scale).astype(np.float32)
    return params


def _pair(cd, extra_dim=0, max_len=12, seed=0):
    """The reference's net (random head) and the port's on its weights."""
    r = np.random.default_rng(seed)
    j = JaxCausalTransformer(hidden_dim=16, num_heads=4, num_layers=2,
                             max_len=max_len, extra_dim=extra_dim,
                             compute_dtype=cd)
    params = _random_head(_np(j.init(jax.random.PRNGKey(seed), 5, 11)), r)
    net = CausalTransformer(5, 11, hidden_dim=16, num_heads=4, num_layers=2,
                            max_len=max_len, extra_dim=extra_dim,
                            compute_dtype=cd)
    net.load_state_dict(flatten_tree(params))
    return j, params, net, r


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["plain", "extra_and_mask"])
def test_forward_and_steps_match_reference(cd, variant):
    """The shifted whole-sequence pass, with and without ``extra`` and a
    key mask (trailing keys masked, one row with a single valid key), and
    three KV-cache steps, against the reference's ``apply`` and ``step``."""
    masked = variant == "extra_and_mask"
    j, params, net, r = _pair(cd, extra_dim=3 if masked else 0)
    x = r.standard_normal((B, T, 5)).astype(np.float32)
    extra = (r.standard_normal((B, T, 3)).astype(np.float32)
             if masked else None)
    mask = None
    if masked:
        mask = (np.arange(T)[None] < np.array([[T], [5], [1], [7]])).astype(
            np.float32)
    want = np.asarray(j.apply(
        params, jnp.asarray(x), mask=None if mask is None else
        jnp.asarray(mask), shift=True,
        extra=None if extra is None else jnp.asarray(extra))).astype(
            np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x),
                  mask=None if mask is None else torch.tensor(mask),
                  shift=True,
                  extra=None if extra is None else torch.tensor(extra))
    assert got.dtype == getattr(torch, cd)
    tol = TOL if cd == "float32" else _bf16_tol(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=tol)

    carry_j, carry_t = j.init_carry(B), net.init_carry(B)
    assert carry_t[0][0][0].shape == (B, 12, 4, 4)
    assert carry_t[0][0][0].dtype == torch.float32
    for t in range(3):
        e = None if extra is None else extra[:, t]
        carry_j, out_j = j.step(params, carry_j, jnp.asarray(x[:, t]),
                                extra_t=None if e is None else
                                jnp.asarray(e))
        with torch.no_grad():
            carry_t, out_t = net.step(carry_t, torch.tensor(x[:, t]),
                                      extra_t=None if e is None else
                                      torch.tensor(e))
        want = np.asarray(out_j).astype(np.float32)
        tol = TOL if cd == "float32" else _bf16_tol(want)
        np.testing.assert_allclose(out_t.float().numpy(), want, rtol=TOL,
                                   atol=tol)
        for cj, (kt, vt) in zip(carry_j[0], carry_t[0]):
            for a, b in ((kt, cj["k"]), (vt, cj["v"])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=TOL, atol=tol)
        assert int(carry_t[1]) == int(carry_j[1]) == t + 1


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_step_rollout_matches_forward(cd):
    """Rolling ``step`` over the shifted inputs gives the batched pass
    (causality and the cache), in the port alone: within 2e-4 in fp32, 2
    bf16 ulps at the output's scale in bf16; the position at the end is
    T and the cache past it still zero."""
    _, _, net, r = _pair(cd, extra_dim=3, max_len=16, seed=1)
    x = torch.tensor(r.standard_normal((3, 10, 5)).astype(np.float32))
    extra = torch.tensor(r.standard_normal((3, 10, 3)).astype(np.float32))
    with torch.no_grad():
        full = net(x, shift=True, extra=extra).float().numpy()
        carry = net.init_carry(3)
        prev = torch.zeros(3, 5)
        outs = []
        for t in range(10):
            carry, o = net.step(carry, prev, extra_t=extra[:, t])
            outs.append(o.float().numpy())
            prev = x[:, t]
    seq = np.stack(outs, axis=1)
    tol = ROLLOUT_TOL if cd == "float32" else _bf16_tol(full)
    np.testing.assert_allclose(seq, full, rtol=ROLLOUT_TOL, atol=tol)
    caches, pos, _ = carry
    assert int(pos) == 10
    for kc, vc in caches:
        assert not kc[:, 10:].any() and not vc[:, 10:].any()
        assert kc[:, :10].abs().sum() > 0


def test_is_causal():
    """With ``shift`` the output at t depends on the inputs before t only:
    changing the inputs from t0 on leaves the outputs up to t0 as they
    were and moves the later ones."""
    _, _, net, r = _pair("float32", seed=2)
    x = torch.tensor(r.standard_normal((2, T, 5)).astype(np.float32))
    t0 = 5
    x2 = x.clone()
    x2[:, t0:] = torch.tensor(r.standard_normal((2, T - t0, 5)).astype(
        np.float32))
    with torch.no_grad():
        y1, y2 = net(x, shift=True), net(x2, shift=True)
    torch.testing.assert_close(y1[:, :t0 + 1], y2[:, :t0 + 1], rtol=1e-5,
                               atol=1e-5)
    assert not torch.allclose(y1[:, t0 + 1:], y2[:, t0 + 1:])


def test_refuses_sequences_past_max_len():
    net = CausalTransformer(3, 4, hidden_dim=8, num_heads=2, max_len=4,
                            compute_dtype="float32")
    with pytest.raises(ValueError, match="max_len"):
        net(torch.zeros(1, 5, 3))


def _hmm_params(r, S, dim):
    return {"start_logits": r.standard_normal(S).astype(np.float32),
            "trans_logits": r.standard_normal((S, S)).astype(np.float32),
            "means": (r.standard_normal((S, dim)) * 2).astype(np.float32),
            "log_scales": (r.standard_normal((S, dim)) * 0.5 - 0.2).astype(
                np.float32)}


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                         minval=1e-6, maxval=1.0 - 1e-6))


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny transformer LM in both frameworks: the reference's
    data-initialised weights, the autoregressive layers' heads random, a
    random HMM prior, carried across."""
    jtask = jlang.LanguageModelingTask(**TINY)
    batch = next(jtask.train_batches(np.random.default_rng(0)))
    jbatch = {"x": jnp.asarray(batch["x"])}
    params = _np(jtask.data_init(jtask.init_params(jax.random.PRNGKey(0)),
                                 jbatch, jax.random.PRNGKey(1)))
    flow = list(params["flow"])
    r = np.random.default_rng(3)
    for li in (2, 6):
        _random_head(flow[li]["net"], r, 0.1)
    flow[-1] = _hmm_params(r, 5, D)
    params["flow"] = tuple(flow)
    ttask = tlang.LanguageModelingTask(**TINY, device="cpu")
    ttask.model.load_state_dict(from_jax_params(ttask, params))
    return jtask, params, ttask, batch, jbatch


def test_tiny_task_matches_reference(tiny_pair):
    """The flow's nets are transformers whose cache is ``seq_len`` long;
    the loss (the encoder's uniforms shared) and the IS bits/char of 4
    chains within 1e-4 of the reference's."""
    jtask, params, ttask, batch, jbatch = tiny_pair
    nets = [m for m in ttask.model.modules()
            if isinstance(m, CausalTransformer)]
    assert len(nets) == 2 and all(n.max_len == T for n in nets)
    key = jax.random.PRNGKey(9)
    jloss = float(jax.jit(jtask.loss)(params, jbatch, key, 0.8))
    with torch.no_grad():
        tloss = float(ttask.loss(batch, 0.8,
                                 noise=torch.tensor(_uniform(key, (B, T, D)))))
    np.testing.assert_allclose(tloss, jloss, rtol=TOL, atol=TOL)
    S = 4
    noise = np.stack([_uniform(k, (B, T, D))
                      for k in jax.random.split(key, S)])
    jbpd = np.asarray(jax.jit(jtask.eval_step, static_argnums=3)(
        params, jbatch, key, S))
    tbpd = ttask.eval_step(batch, S, noise=torch.tensor(noise)).numpy()
    np.testing.assert_allclose(tbpd, jbpd, rtol=TOL, atol=TOL)


def test_flow_roundtrip_and_sample_match_reference(tiny_pair):
    """The transformer-backed flow's forward then its inverse (the KV-cache
    loop) give z back within 2e-4 and cancel the ldj within 1e-3, as the
    reference's test; a sample from shared prior noise decodes to the
    reference's characters."""
    jtask, params, ttask, _, _ = tiny_pair
    r = np.random.default_rng(5)
    z = torch.tensor(r.standard_normal((B, T, D)).astype(np.float32))
    zero = torch.zeros(B)
    flow = ttask.model.flow
    with torch.no_grad():
        y, ldj_f = flow(z, zero)
        back, ldj_b = flow.inverse(y, zero)
    np.testing.assert_allclose(back.numpy(), z.numpy(), rtol=ROLLOUT_TOL,
                               atol=ROLLOUT_TOL)
    np.testing.assert_allclose(ldj_f.numpy(), -ldj_b.numpy(), rtol=1e-3,
                               atol=1e-3)

    u = _uniform(jax.random.PRNGKey(10), (B, T, D))
    zk = np.log(u) - np.log1p(-u)
    jz, _ = jtask.model.flow.inverse(params["flow"], jnp.asarray(zk))
    jx = jtask.model.encoding.decode(params["encoding"], jz)
    with torch.no_grad():
        tz, _ = flow.inverse(torch.tensor(zk))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(ttask.model.encoding.decode(tz).numpy(),
                                  np.asarray(jx))


def test_cli_run_with_the_transformer_is_served(tmp_path):
    """``--net transformer`` trains a tiny run on the CPU; ``load_run``
    restores it with the transformer and the server's ``/sample`` payload
    is text of ``seq_len`` characters."""
    from categoricalnf_tpu_torch.experiments import language_modeling
    from categoricalnf_tpu_torch.inference import load_run
    from categoricalnf_tpu_torch.serve import RunServer
    out = str(tmp_path / "run")
    final = language_modeling.main([
        "--device", "cpu", "--corpus", "synthetic", "--seq_len", "8",
        "--batch_size", "32", "--encoding_dim", "2", "--num_layers", "1",
        "--hidden_dim", "8", "--lstm_layers", "1", "--num_mixtures", "3",
        "--net", "transformer", "--compute_dtype", "float32", "--num_steps",
        "4", "--eval_every", "2", "--eval_samples", "2", "--log_every", "2",
        "--out_dir", out])
    assert np.isfinite(final["best_bpd"]) and "bigram_kl_bits" in final
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["args"]["net"] == "transformer"
    handle = load_run(out, device="cpu")
    assert handle.task.net == "transformer" and handle.step == 4
    nets = [m for m in handle.task.model.modules()
            if isinstance(m, CausalTransformer)]
    assert nets and all(n.max_len == 8 for n in nets)
    texts = RunServer(out, device="cpu").sample(3, 1.0)
    assert len(texts) == 3 and all(isinstance(t, str) and len(t) == 8
                                   for t in texts)
    assert isinstance(handle.task.model.flow.layers[2],
                      tflows.AutoregressiveMixtureCDF)
