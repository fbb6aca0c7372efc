"""The port's language-modeling slice against the JAX package, on the CPU.

``CausalLSTM`` (the whole-sequence pass and the step-by-step rollout, fp32
and bf16), ``AutoregressiveMixtureCDF`` (forward, and the sequential
inverse, for parity None, 0 and 1, with and without input features), the
HMM prior (masked and unmasked) and ``FlowModel`` with it, the synthetic
corpus and its crops (element for element), and a tiny
``LanguageModelingTask`` (seq_len 8, hidden 16, K = 4, one block, the HMM
prior): loss and IS bits/char on the reference's weights carried across by
``convert.from_jax_params``, with shared noise.  fp32 within rtol/atol
1e-4; bf16 within 2 bf16 ulps at the output's scale, as the port's other
bf16 parity tests.  Then the mixture kernels' K <= 32 geometry as
``csrc/mixture.cu`` builds it, and the port's own surfaces on the CPU: the
CLI, the checkpointed run behind ``inference``, ``serve``'s payload and the
post-hoc CLIs.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu import flows as jflows
from categoricalnf_tpu.data import native_loader
from categoricalnf_tpu.networks.lstm import CausalLSTM as JaxLSTM
from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu.ops.pallas.mixture import mixture_forward_pallas
from categoricalnf_tpu.tasks import language as jlang
from categoricalnf_tpu_torch import flows as tflows
from categoricalnf_tpu_torch.convert import flatten_tree, from_jax_params
from categoricalnf_tpu_torch.data import corpus as tcorpus
from categoricalnf_tpu_torch.networks import CausalLSTM
from categoricalnf_tpu_torch.ops import numerics as tnm
from categoricalnf_tpu_torch.ops.cuda import build
from categoricalnf_tpu_torch.tasks import language as tlang

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

TOL = 1e-4
B, T, D, K = 4, 8, 4, 4
TINY = dict(corpus_name="synthetic", seq_len=T, batch_size=B,
            encoding_dim=D, num_layers=1, hidden_dim=16, lstm_layers=2,
            num_mixtures=K, eval_batches_count=1, compute_dtype="float32",
            prior="hmm", prior_states=5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16_tol(want):
    """2 bf16 ulps at the output's scale: the frameworks round the same
    bf16 operations, but sum the fp32 contractions in another order and
    evaluate sigmoid and tanh with another rounding, so a rounding to
    bf16 can flip."""
    return 2.0 ** -6 * float(np.abs(want).max())


def _random_head(params, r, scale=0.3):
    for k in ("w", "b"):
        params["out"][k] = (r.standard_normal(params["out"][k].shape)
                            * scale).astype(np.float32)
    return params


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lstm_matches_reference(cd):
    """The whole-sequence pass (shifted, with extra features) and the
    step-by-step rollout, on the reference's weights with a random head."""
    r = np.random.default_rng(0)
    j = JaxLSTM(hidden_dim=16, num_layers=2, extra_dim=3, compute_dtype=cd)
    params = _random_head(_np(j.init(jax.random.PRNGKey(0), 5, 11)), r)
    net = CausalLSTM(5, 11, hidden_dim=16, num_layers=2, extra_dim=3,
                     compute_dtype=cd)
    net.load_state_dict(flatten_tree(params))
    x = r.standard_normal((B, T, 5)).astype(np.float32)
    extra = r.standard_normal((B, T, 3)).astype(np.float32)
    want = np.asarray(j.apply(params, jnp.asarray(x), shift=True,
                              extra=jnp.asarray(extra))).astype(np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x), shift=True, extra=torch.tensor(extra))
    assert got.dtype == getattr(torch, cd)
    tol = TOL if cd == "float32" else _bf16_tol(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=tol)

    carry_j, carry_t = j.init_carry(B), net.init_carry(B)
    assert carry_t[0][0].dtype == torch.float32
    for t in range(3):
        carry_j, out_j = j.step(params, carry_j, jnp.asarray(x[:, t]),
                                extra_t=jnp.asarray(extra[:, t]))
        with torch.no_grad():
            carry_t, out_t = net.step(carry_t, torch.tensor(x[:, t]),
                                      extra_t=torch.tensor(extra[:, t]))
        want = np.asarray(out_j).astype(np.float32)
        tol = TOL if cd == "float32" else _bf16_tol(want)
        np.testing.assert_allclose(out_t.float().numpy(), want, rtol=TOL,
                                   atol=tol)
        for (hj, cj), (ht, ct) in zip(carry_j, carry_t):
            assert ht.dtype == ct.dtype == torch.float32
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                                       rtol=TOL, atol=TOL if cd == "float32"
                                       else 2.0 ** -7)


def test_lstm_is_causal_and_steps_like_the_pass():
    """The output at t depends on the inputs before t only, and rolling
    ``step`` over the shifted inputs gives the whole pass."""
    g = torch.Generator().manual_seed(0)
    net = CausalLSTM(3, 5, hidden_dim=8, num_layers=2,
                     compute_dtype="float32", generator=g)
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape, generator=g))
        x = torch.randn(2, 6, 3, generator=g)
        y = net(x)
        x2 = x.clone()
        x2[:, 3] += 5.0
        y2 = net(x2)
        torch.testing.assert_close(y[:, :4], y2[:, :4])
        assert not torch.allclose(y[:, 4:], y2[:, 4:])
        carry, inp, outs = net.init_carry(2), torch.zeros(2, 3), []
        for t in range(6):
            carry, o = net.step(carry, inp)
            outs.append(o)
            inp = x[:, t]
    torch.testing.assert_close(torch.stack(outs, 1), y, rtol=1e-5,
                               atol=1e-5)


def _ar_pair(parity, input_feats, seed=0):
    r = np.random.default_rng(seed)
    out_dim = D * (2 + 3 * K)
    extra = D if parity is not None else 0
    jl = jflows.AutoregressiveMixtureCDF(
        net=JaxLSTM(hidden_dim=16, num_layers=2, extra_dim=extra,
                    compute_dtype="float32"),
        num_mixtures=K, parity=parity, input_feats=input_feats)
    params = _np(jl.init(jax.random.PRNGKey(seed), D))
    _random_head(params["net"], r, 0.2)
    tl = tflows.AutoregressiveMixtureCDF(
        CausalLSTM(D + input_feats, out_dim, hidden_dim=16, num_layers=2,
                   extra_dim=extra, compute_dtype="float32"),
        D, num_mixtures=K, parity=parity, input_feats=input_feats)
    tl.load_state_dict(flatten_tree(params))
    z = r.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None] < r.integers(4, T + 1, (B, 1))).astype(
        np.float32)
    return jl, params, tl, z, mask


@pytest.mark.parametrize("input_feats", [0, 3], ids=["raw", "feats"])
@pytest.mark.parametrize("parity", [None, 0, 1])
def test_autoregressive_matches_reference(parity, input_feats):
    """Forward (masked ldj) and the sequential inverse within 1e-4 of the
    reference's; the port's inverse takes its forward back to z."""
    jl, params, tl, z, mask = _ar_pair(parity, input_feats)
    ldj0 = np.zeros(B, np.float32)
    jy, jldj = jl.forward(params, jnp.asarray(z), jnp.asarray(ldj0),
                          mask=jnp.asarray(mask))
    with torch.no_grad():
        ty, tldj = tl(torch.tensor(z), torch.tensor(ldj0),
                      mask=torch.tensor(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=TOL,
                               atol=TOL)
    if parity is not None:
        keep = tflows.make_channel_mask(D, parity).bool()
        np.testing.assert_array_equal(ty[..., keep].numpy(), z[..., keep])

    jx, jildj = jl.inverse(params, jy, jnp.asarray(ldj0),
                           mask=jnp.asarray(mask))
    with torch.no_grad():
        tx, tildj = tl.inverse(ty, torch.tensor(ldj0),
                               mask=torch.tensor(mask))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tildj.numpy(), np.asarray(jildj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tx.numpy(), z, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tildj.numpy(), -tldj.numpy(), rtol=1e-3,
                               atol=1e-3)


def _hmm_params(r, S, dim):
    return {"start_logits": r.standard_normal(S).astype(np.float32),
            "trans_logits": r.standard_normal((S, S)).astype(np.float32),
            "means": (r.standard_normal((S, dim)) * 2).astype(np.float32),
            "log_scales": (r.standard_normal((S, dim)) * 0.5 - 0.2).astype(
                np.float32)}


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_hmm_log_prob_matches_reference(masked):
    """Both branches of the forward recursion within 1e-4, the masked one
    with trailing, interior, leading and all-masked rows; the log-scales
    reach past the clip."""
    r = np.random.default_rng(1)
    S, dim, Tn = 5, 3, 7
    p = _hmm_params(r, S, dim)
    p["log_scales"][0, 0] = -6.0
    z = (r.standard_normal((5, Tn, dim)) * 1.5).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((5, Tn), np.float32)
        mask[0, 5:] = 0
        mask[1, [2, 3]] = 0
        mask[2, :2] = 0
        mask[3] = 0
    want = np.asarray(jflows.HMMPrior(num_states=S).log_prob(
        p, jnp.asarray(z), None if mask is None else jnp.asarray(mask)))
    prior = tflows.HMMPrior(dim, S)
    prior.load_state_dict(flatten_tree(p))
    with torch.no_grad():
        got = prior.log_prob(torch.tensor(z), None if mask is None
                             else torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if masked:
        assert got[3] == 0.0


def test_flow_model_with_parametric_prior():
    """The HMM prior is a submodule of the flow (its parameters train with
    the layers'); log_prob matches the reference on the same parameters;
    a round trip ignores the prior; the sampler's chain follows its noise
    and its temperature."""
    r = np.random.default_rng(2)
    jm = jflows.FlowModel(layers=(jflows.ActNorm(),
                                  jflows.InvertibleLinear()),
                          prior=jflows.HMMPrior(num_states=5))
    params = _np(jm.init(jax.random.PRNGKey(0), D))
    params = (*params[:-1], _hmm_params(r, 5, D))
    tm = tflows.FlowModel([tflows.ActNorm(D), tflows.InvertibleLinear(D)],
                          prior=tflows.create_prior("hmm", D, num_states=5))
    state = {**flatten_tree(list(params[:-1]), "layers."),
             **flatten_tree(params[-1], "prior.")}
    tm.load_state_dict(state)
    names = {n for n, _ in tm.named_parameters()}
    assert {"prior.trans_logits", "prior.means"} <= names
    z0 = r.standard_normal((3, 6, D)).astype(np.float32)
    want = np.asarray(jax.jit(jm.log_prob)(params, jnp.asarray(z0)))
    with torch.no_grad():
        got = tm.log_prob(torch.tensor(z0)).numpy()
        zk, _ = tm(torch.tensor(z0))
        rec, _ = tm.inverse(zk)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rec.numpy(), z0, atol=1e-4)

    prior = tm.prior
    assert prior.noise_shape((3, 6, D)) == (3, 6, D + 1)
    u = tnm.uniform_noise((64, 6, D + 1),
                          generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        s1 = prior.sample((64, 6, D), noise=u)
        s2 = prior.sample((64, 6, D), noise=u)
        cold = prior.sample((64, 6, D), 0.05, noise=u)
        lp_cold, lp_hot = prior.log_prob(cold), prior.log_prob(s1)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    assert s1.shape == (64, 6, D) and torch.isfinite(s1).all()
    assert lp_cold.mean() > lp_hot.mean()
    for name in ("logistic", "gaussian", "normal", None):
        assert not isinstance(tflows.create_prior(name, D), torch.nn.Module)
    with pytest.raises(ValueError, match="unknown prior"):
        tflows.create_prior("cauchy", D)


def test_corpus_streams_equal_the_reference():
    """The port's copy of the C++ generators: the synthetic corpus (its
    chain, split, kernel and optimum) and the crops, element for element,
    at a length of 10^5; the crops of the task's batch streams too."""
    if tcorpus.library() is None or native_loader.get_lib() is None:
        pytest.fail("the host compiler did not build the corpus library")
    jc = jlang.synthetic_markov_corpus(vocab_size=27, length=100_000, seed=2)
    tc = tlang.synthetic_markov_corpus(vocab_size=27, length=100_000, seed=2)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(tc.splits[split], jc.splits[split])
        assert tc.splits[split].dtype == np.int32
    np.testing.assert_array_equal(tc.transition_matrix, jc.transition_matrix)
    assert tc.analytic_bpc == jc.analytic_bpc and tc.vocab == jc.vocab
    stream = tc.splits["train"]
    for seed in (0, 5, 2**62 + 3):
        np.testing.assert_array_equal(
            tcorpus.chunk_corpus(seed, stream, 64, 256),
            native_loader.chunk_corpus(seed, stream, 64, 256))


def test_corpus_library_is_the_ports_own():
    """The C++ generators the port builds are its own copy, under its
    package, including only standard headers, and built into its
    git-ignored ``_build/``; nothing of the JAX package is loaded."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tcorpus.__file__)))
    assert os.path.commonpath([tcorpus.SRC, pkg]) == pkg
    with open(tcorpus.SRC) as f:
        src = f.read()
    assert re.findall(r"#include <(\w+)>", src) == ["cstdint", "cstring"]
    assert "categoricalnf_tpu/" not in src.replace(
        "categoricalnf_tpu/data/native/datagen.cpp", "")
    lib = tcorpus.library()
    assert lib is not None
    assert os.path.commonpath([lib._name, build.BUILD_DIR]) == build.BUILD_DIR


def test_load_corpus_fallbacks(tmp_path):
    """PTB and text8 fall back to the reference's synthetic corpora where
    their files are absent, and read the files where they are there."""
    for name in ("ptb", "text8"):
        got = tlang.load_corpus(name, str(tmp_path))
        assert got.name == "synthetic_markov"
        assert got.vocab_size == (50 if name == "ptb" else 27)
    (tmp_path / "text8").write_text("the cat sat on the mat " * 50)
    for split, fname in tlang.PTB_FILES.items():
        (tmp_path / fname).write_text("a b _ c\nb a _\n" * 20)
    t8, ptb = (tlang.load_corpus(n, str(tmp_path)) for n in ("text8", "ptb"))
    j8, jptb = (jlang.load_corpus(n, str(tmp_path)) for n in ("text8", "ptb"))
    for a, b in ((t8, j8), (ptb, jptb)):
        assert a.name == b.name and a.vocab == b.vocab
        for split in ("train", "valid", "test"):
            np.testing.assert_array_equal(a.splits[split], b.splits[split])


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny task in both frameworks: the reference's data-initialised
    weights, the AR layers' heads random, carried across."""
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


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                         minval=1e-6, maxval=1.0 - 1e-6))


def test_tiny_task_matches_reference(tiny_pair):
    """Loss (the encoder's uniforms shared) and the IS bits/char of 4
    chains within 1e-4; the task's batches are the reference's."""
    jtask, params, ttask, batch, jbatch = tiny_pair
    assert ttask.name == jtask.name == "lm_synthetic_markov"
    assert ttask.analytic_optimum_bpd() == jtask.analytic_optimum_bpd()
    tb = next(ttask.train_batches(np.random.default_rng(0)))
    np.testing.assert_array_equal(tb["x"], batch["x"])
    for a, b in zip(ttask.eval_batches(), jtask.eval_batches()):
        np.testing.assert_array_equal(a["x"], b["x"])
    for a, b in zip(ttask.test_batches(), jtask.test_batches()):
        np.testing.assert_array_equal(a["x"], b["x"])

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
    assert np.isfinite(tbpd).all() and (tbpd > 0).all()


def test_scanned_stack_converts(tiny_pair):
    """Two blocks: the reference scans them (one ``ScannedBlocks`` whose
    leaves carry a depth axis, the HMM prior after it); the port holds a
    block of modules for each depth.  The converted weights give the
    reference's loss within 1e-4."""
    jtask = jlang.LanguageModelingTask(**{**TINY, "num_layers": 2})
    batch = tiny_pair[3]
    params = _np(jtask.init_params(jax.random.PRNGKey(4)))
    stack, prior = params["flow"]
    r = np.random.default_rng(5)
    for li in (2, 6):
        for k in ("w", "b"):
            v = stack[li]["net"]["out"][k]
            stack[li]["net"]["out"][k] = (r.standard_normal(v.shape)
                                          * 0.1).astype(np.float32)
    ttask = tlang.LanguageModelingTask(**{**TINY, "num_layers": 2},
                                       device="cpu")
    (scan,) = ttask.model.flow.layers
    assert isinstance(scan, tflows.ScannedBlocks) and len(scan.blocks) == 2
    state = from_jax_params(ttask, params)
    np.testing.assert_array_equal(
        state["flow.layers.0.blocks.1.6.net.cells.1.wh.w"].numpy(),
        stack[6]["net"]["cells"][1]["wh"]["w"][1])
    np.testing.assert_array_equal(state["flow.prior.trans_logits"].numpy(),
                                  prior["trans_logits"])
    ttask.model.load_state_dict(state)
    key = jax.random.PRNGKey(11)
    jloss = float(jax.jit(jtask.loss)(params, {"x": jnp.asarray(batch["x"])},
                                      key, 1.0))
    with torch.no_grad():
        tloss = float(ttask.loss(batch, 1.0,
                                 noise=torch.tensor(_uniform(key, (B, T, D)))))
    np.testing.assert_allclose(tloss, jloss, rtol=TOL, atol=TOL)


def test_tiny_task_samples_and_metrics(tiny_pair, tmp_path):
    """A sample with shared prior noise decodes to the reference's
    characters through the flow's inverse; the sample metrics' columns;
    the samples written to the run directory."""
    jtask, params, ttask, _, _ = tiny_pair
    u = _uniform(jax.random.PRNGKey(10), (B, T, D))
    zk = np.log(u) - np.log1p(-u)
    jz, _ = jtask.model.flow.inverse(params["flow"], jnp.asarray(zk))
    jx = jtask.model.encoding.decode(params["encoding"], jz)
    with torch.no_grad():
        tz, _ = ttask.model.flow.inverse(torch.tensor(zk))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(ttask.model.encoding.decode(tz).numpy(),
                                  np.asarray(jx))
    g = torch.Generator().manual_seed(0)
    m = ttask.sample_metrics(generator=g, num_samples=6)
    assert set(m) == {"unigram_tv", "bigram_kl_bits", "metric_num_samples"}
    assert m["metric_num_samples"] == 6.0 and 0 <= m["unigram_tv"] <= 1
    texts = ttask.sample_text(3, generator=g)
    assert len(texts) == 3 and all(len(t) == T for t in texts)
    assert set("".join(texts)) <= set(ttask.corpus.vocab)
    ttask.sample_artifacts(str(tmp_path), generator=g)
    assert (tmp_path / "samples.txt").read_text().count("\n---\n") == 8


# -- the mixture kernels at K <= 32 -------------------------------------


def _mixture_source():
    with open(os.path.join(build.CSRC, "mixture.cu")) as f:
        return re.sub(r"\s+", " ", f.read())


@pytest.mark.parametrize("kernel,entry,launch", [
    ("inverse", "int mixture_inverse_f32(", "inverse_launch"),
    ("forward", "int mixture_forward_f32(", "forward_launch"),
    ("backward", "int mixture_forward_bwd_f32(", "bwd_launch")])
def test_wide_groups_mirror_the_source(kernel, entry, launch):
    """For 16 < K <= 32 each entry point launches its wide group, lanes
    times components 32 with whole groups in a warp; the wrapper takes
    K up to 32."""
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    src = _mixture_source()
    lanes = dict(zip(("forward", "backward", "inverse"), map(int, re.search(
        r"constexpr int kWideFwdLanes = (\d+), kWideBwdLanes = (\d+), "
        r"kWideInvLanes = (\d+);", src).groups())))[kernel]
    name = {"forward": "kWideFwdLanes", "backward": "kWideBwdLanes",
            "inverse": "kWideInvLanes"}[kernel]
    body = src[src.index(entry):]
    body = body[:body.index("return (int)cudaGetLastError")]
    assert f"if (k > 16) {launch}<{name}, 32 / {name}>(" in body
    assert 32 % lanes == 0 and (32 // lanes) * lanes == 32
    assert cm.MAX_K == 32


def _relayed(terms, lanes):
    """The kernels' relayed sum: lane l adds its C components in order to
    what lane l - 1 passed it, from 0.0f."""
    run = np.zeros(terms.shape[0], np.float32)
    c = terms.shape[1] // lanes
    for lane in range(lanes):
        for j in range(c * lane, c * lane + c):
            run = (run + terms[:, j]).astype(np.float32)
    return run


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_wide_relay_is_the_per_element_loop(lanes):
    """At K = 32 the relayed sums over any split of lanes are the
    per-element loop's sums bit for bit (so the split is a matter of time
    only), components past k adding an exact +0."""
    r = np.random.default_rng(lanes)
    for k in (17, 24, 32):
        e = np.exp(r.standard_normal((4096, k)) * 8).astype(np.float32)
        loop = np.zeros(4096, np.float32)
        for j in range(k):
            loop = (loop + e[:, j]).astype(np.float32)
        padded = np.concatenate([e, np.zeros((4096, 32 - k), np.float32)], 1)
        np.testing.assert_array_equal(_relayed(padded, lanes), loop)


def _dot2(a, b, lanes):
    """csrc/mixture.cu's group_dot2 in numpy fp32: per lane, each product
    and sum with its exact rounding error (fmaf, TwoSum) summed beside, the
    pair relayed lane to lane, added once at the end."""
    f32 = np.float32
    run, err = np.zeros(a.shape[0], f32), np.zeros(a.shape[0], f32)
    c = a.shape[1] // lanes
    for j in range(a.shape[1]):
        p = (a[:, j] * b[:, j]).astype(f32)
        pe = (a[:, j].astype(np.float64) * b[:, j] - p).astype(f32)
        s = (run + p).astype(f32)
        bb = (s - run).astype(f32)
        e = ((run - (s - bb).astype(f32)).astype(f32)
             + (p - bb).astype(f32)).astype(f32)
        run, err = s, (err + (pe + e).astype(f32)).astype(f32)
    assert c * lanes == a.shape[1]
    return (run + err).astype(f32)


def test_wide_inverse_sums_are_compensated():
    """The inverse sums F and S with group_dot2 above 8 components (K =
    16 and 32), with the plain fmaf chain at K <= 8.  Modelled in numpy on
    the weights and sigmoids of 32 components, the compensated sum is
    within one fp32 rounding of the exact one, where the chain is off by
    several on some elements."""
    src = _mixture_source()
    assert ("float F, S; if constexpr (G * C > 8) { F = group_dot2<G, C>"
            "(q.w, sig); S = group_dot2<G, C>(q.w, sig_neg); } else { F = "
            "group_dot<G, C>(q.w, sig); S = group_dot<G, C>(q.w, sig_neg); "
            "}") in src
    r = np.random.default_rng(0)
    w = np.exp(r.standard_normal((20000, 32))).astype(np.float32)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    sig = (1 / (1 + np.exp(-r.standard_normal((20000, 32)) * 3))).astype(
        np.float32)
    exact = (w.astype(np.float64) * sig).sum(1)
    chain = np.zeros(20000, np.float32)
    for j in range(32):
        chain = (w[:, j].astype(np.float64) * sig[:, j] + chain).astype(
            np.float32)
    comp = _dot2(w, sig, 4)
    ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
    assert (np.abs(comp - exact) <= ulp).all()
    assert (np.abs(chain - exact) > 2 * ulp).any()


@pytest.mark.parametrize("k", [24, 32])
def test_wide_forward_plain_matches_reference(k):
    """The plain version of #2 at K up to 32 (what the card holds the
    kernel to) against the reference's numerics and, at K = 32, its Pallas
    kernel in interpret mode, at the LM's strided parameter rows."""
    r = np.random.default_rng(k)
    raw = r.standard_normal((2, 5, D, 2 + 3 * k)).astype(np.float32) * 2
    x = r.standard_normal((2, 5, D)).astype(np.float32) * 2
    pi, mu, ls = raw[..., 2:2 + k], raw[..., 2 + k:2 + 2 * k], \
        raw[..., 2 + 2 * k:] * 0.5 - 0.5
    y, ldj = tnm.mixture_logit_cdf_and_ldj(
        torch.tensor(x), *(torch.tensor(a) for a in (pi, mu, ls)))
    wants = [jnm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)]
    if k == 32:
        wants.append(mixture_forward_pallas(
            jnp.asarray(x), jnp.asarray(pi), jnp.asarray(mu),
            jnp.asarray(ls), interpret=True))
    for want in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ldj.numpy(), np.asarray(want[1]),
                                   rtol=TOL, atol=TOL)
    xi = tnm.mixture_inverse_logit_cdf(y, *(torch.tensor(a)
                                            for a in (pi, mu, ls)))
    np.testing.assert_allclose(xi.numpy(), x, rtol=1e-3, atol=1e-3)


# -- the port's own surfaces -------------------------------------------


def _cli(out, *extra):
    from categoricalnf_tpu_torch.experiments import language_modeling
    return language_modeling.main([
        "--device", "cpu", "--corpus", "synthetic", "--seq_len", "8",
        "--batch_size", "64", "--encoding_dim", "2", "--num_layers", "2",
        "--hidden_dim", "8", "--lstm_layers", "1", "--num_mixtures", "3",
        "--compute_dtype", "float32", "--prior", "hmm", "--prior_states",
        "3", "--num_steps", "4", "--eval_every", "2", "--eval_samples", "2",
        "--log_every", "2", "--out_dir", out, *extra])


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm") / "run")
    return out, _cli(out, "--steps_per_call", "2")


def test_cli_trains_and_writes_the_run(cli_run):
    out, final = cli_run
    assert np.isfinite(final["best_bpd"]) and "test_bpd" in final
    assert "bigram_kl_bits" in final
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["task"] == "lm_synthetic_markov"
    assert cfg["args"]["prior"] == "hmm"
    rows = [json.loads(line) for line in open(os.path.join(out,
                                                           "metrics.jsonl"))]
    assert [r["step"] for r in rows if r["prefix"] == "val"] == [2, 4]
    assert os.path.exists(os.path.join(out, "samples.txt"))


def test_served_run_and_post_hoc_clis(cli_run):
    """inference restores the run (saved keys the task does not know, as
    lm_v6's ``decoder``, fall to the defaults), serve's payload is text,
    and the post-hoc CLIs run on it."""
    from categoricalnf_tpu_torch.experiments import eval_bpd, sample_eval
    from categoricalnf_tpu_torch.inference import build_task, load_run
    from categoricalnf_tpu_torch.serve import RunServer
    out, _ = cli_run
    handle = load_run(out, device="cpu")
    assert handle.task.prior == "hmm" and handle.step in (2, 4)
    assert isinstance(handle.task.model.flow.prior, tflows.HMMPrior)
    task = build_task("lm_synthetic_markov",
                      {"corpus": "synthetic", "seq_len": 8, "decoder": "mlp",
                       "vardeq_blocks": 2, "hidden_dim": 8,
                       "lstm_layers": 1, "num_layers": 1}, device="cpu")
    assert task.corpus_name == "synthetic" and task.seq_len == 8
    server = RunServer(out, device="cpu")
    texts = server.sample(3, 1.0)
    assert len(texts) == 3 and all(isinstance(t, str) and len(t) == 8
                                   for t in texts)
    m = server.sample_metrics(4, 0.9)
    assert m["metric_num_samples"] == 4.0
    ev = eval_bpd.main(["--run", out, "--device", "cpu", "--num_samples",
                        "2", "--max_batches", "1"])
    assert np.isfinite(ev["bpd"])
    (row,) = sample_eval.main(["--run", out, "--device", "cpu",
                               "--num_samples", "4", "--temperatures",
                               "1.0"])
    assert row["metric_num_samples"] == 4.0 and "bigram_kl_bits" in row
