"""The port's training slice against the JAX package, on the CPU.

The loss and its gradient per parameter (``task.loss``), the positive-ELBO
penalty, the plain SetTransformer's and the mixture CDF's gradients, the
optimizer, the beta schedule; then the port's Trainer (progress, resume,
SIGTERM), its checkpoints and the training CLI, whose run the port's
``load_run`` serves.  Both frameworks start from the same JAX-initialised
parameters (``convert.from_jax_params``) and the same uniform noise.
"""

import functools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_slice
from categoricalnf_tpu import flows as jflows
from categoricalnf_tpu.networks.transformer import \
    SetTransformer as JaxSetTransformer
from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu.ops.pallas import fused_transformer as jft
from categoricalnf_tpu.tasks.set_modeling import \
    SetShufflingTask as JaxSetShufflingTask
from categoricalnf_tpu.training import OptimizerConfig as JaxOptimizerConfig
from categoricalnf_tpu.training import ScheduleSpec as JaxScheduleSpec
from categoricalnf_tpu_torch.convert import flatten_tree, from_jax_params
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.ops import numerics as nm
from categoricalnf_tpu_torch.tasks import SetShufflingTask
from categoricalnf_tpu_torch.training.engine import TrainConfig, Trainer
from categoricalnf_tpu_torch.training.schedules import ScheduleSpec
from categoricalnf_tpu_torch.training.state import (OptimizerConfig,
                                                    TrainState)

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

B, T, D = 16, 8, 4
TINY = dict(set_size=T, batch_size=B, num_layers=2, hidden_dim=32,
            num_mixtures=4, encoding_dim=D, eval_batches_count=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(compute_dtype):
    """The reference's data-initialised weights for the tiny task, with
    random coupling output layers (zero ones make every coupling the
    identity and its net's gradient vanish)."""
    jtask = JaxSetShufflingTask(**{**TINY, "compute_dtype": compute_dtype})
    x = np.argsort(np.random.default_rng(7).random((B, T)), axis=1)
    params = jax.jit(jtask.data_init)(
        jax.jit(jtask.init_params)(jax.random.PRNGKey(0)),
        {"x": jnp.asarray(x)}, jax.random.PRNGKey(1))
    params = _np(params)
    r = np.random.default_rng(3)
    for i, layer in enumerate(jtask.model.flow.layers):
        if isinstance(layer, jflows.MixtureCDFCoupling):
            out = params["flow"][i]["net"]["out"]
            out["w"] = (r.standard_normal(out["w"].shape) * 0.05).astype(
                np.float32)
    return jtask, params, x


def _pair(compute_dtype="float32"):
    """The tiny task in both frameworks on the same weights."""
    jtask, params, x = _jax_params(compute_dtype)
    ttask = SetShufflingTask(**TINY, compute_dtype=compute_dtype,
                             device="cpu")
    ttask.model.load_state_dict(from_jax_params(ttask, params))
    return jtask, params, ttask, x


def _jax_loss_and_grad(jtask, params, x, u, beta, monkeypatch):
    """``jax.value_and_grad`` of the reference's ``task.loss`` with its
    encoder's uniform draw replaced by ``u``; gradients named as the port's
    parameters."""
    def sample(rng, shape, mean=0.0, log_scale=0.0):
        logit_u = jnp.log(u) - jnp.log1p(-u)
        return jnp.float32(mean) + jnp.exp(jnp.float32(log_scale)) * logit_u
    monkeypatch.setattr(jnm, "logistic_sample", sample)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss(p, {"x": jnp.asarray(x)},
                             jax.random.PRNGKey(5), beta)))(params)
    grads = _np(grads)
    flat = {**flatten_tree(grads["encoding"], "encoding."),
            **flatten_tree(list(grads["flow"]), "flow.layers.")}
    return float(loss), {k: v.numpy() for k, v in flat.items()}


def _port_loss_and_grad(ttask, x, u, beta):
    loss = ttask.loss({"x": x}, beta, noise=torch.tensor(u))
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in
                                  ttask.model.named_parameters()}


def _uniform(seed, extreme=False):
    r = np.random.default_rng(seed)
    u = r.uniform(1e-6, 1 - 1e-6, (B, T, D))
    if extreme:  # 30% of draws deep in q's tails: -log q, and the ELBO, grow
        tails = np.where(r.random((B, T, D)) < 0.5, 1e-6, 1 - 1e-6)
        u = np.where(r.random((B, T, D)) < 0.3, tails, u)
    return u.astype(np.float32)


@pytest.mark.parametrize("beta,extreme", [(1.0, False), (0.6, False),
                                          (1.0, True)])
def test_loss_and_gradients_match_reference_fp32(beta, extreme,
                                                 monkeypatch):
    """fp32: the loss to 1e-5 and every parameter's gradient to rtol 1e-4,
    atol 1e-5; ``extreme`` noise drives the batch-mean ELBO positive, so the
    positive-ELBO penalty is active."""
    jtask, params, ttask, x = _pair()
    u = _uniform(11, extreme)
    jloss, jgrads = _jax_loss_and_grad(jtask, params, x, u, beta,
                                       monkeypatch)
    tloss, tgrads = _port_loss_and_grad(ttask, x, u, beta)
    if extreme:
        with torch.no_grad():
            elbo = ttask.model.elbo(torch.tensor(x), noise=torch.tensor(u))
        assert float(elbo["elbo"].mean()) > 0  # the penalty is on
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-5)
    # the reference's untrained buffers (perm, sign_s) get no gradient
    assert set(tgrads) <= set(jgrads)
    for k in set(jgrads) - set(tgrads):
        assert not jgrads[k].any(), k
    for k, g in tgrads.items():
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_loss_and_gradients_match_reference_bf16(monkeypatch):
    """bf16 nets round at other places in the two frameworks (and bf16
    roundings flip on fp32 noise), so this case is held loosely: the loss
    to 1% and each gradient tensor to 10% of its norm, or 1e-3 absolute
    where the tensor is near zero."""
    jtask, params, ttask, x = _pair("bfloat16")
    u = _uniform(12)
    jloss, jgrads = _jax_loss_and_grad(jtask, params, x, u, 1.0, monkeypatch)
    tloss, tgrads = _port_loss_and_grad(ttask, x, u, 1.0)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
    for k, g in tgrads.items():
        err = np.linalg.norm(g.numpy() - jgrads[k])
        assert err <= 0.1 * np.linalg.norm(jgrads[k]) + 1e-3, k


def test_set_transformer_gradient_matches_reference_and_pallas():
    """The plain SetTransformer's gradient (the backward kernel's plain
    version) against ``jax.grad`` through the reference's ``apply`` and
    through ``_fused_apply`` (its Pallas VJP, interpret mode): 2e-4, the
    tolerance of the reference's own test."""
    S, IN, H, OUT = 4, 4, 24, 4 * 11
    jnet = JaxSetTransformer(hidden_dim=H, num_heads=4, num_layers=2,
                             compute_dtype="float32")
    params = _np(jax.jit(jnet.init, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), IN, OUT))
    r = np.random.default_rng(1)
    params["out"]["w"] = (r.standard_normal((H, OUT)) * 0.1).astype(
        np.float32)
    x = r.standard_normal((8, S, IN)).astype(np.float32)
    cfg = jft.FusedCfg(H, 4, 2, 2, "float32", OUT, S)

    def loss_apply(p, x_):
        return jnp.sum(jnp.sin(jnet.apply(p, x_)))

    def loss_fused(p, x_):
        y = jft._fused_apply(cfg, True, x_.reshape(-1, IN),
                             jft.flatten_params(p, 2))
        return jnp.sum(jnp.sin(y))

    tnet = SetTransformer(IN, OUT, hidden_dim=H, num_heads=4,
                          compute_dtype="float32")
    tnet.load_state_dict(flatten_tree(params))
    tx = torch.tensor(x, requires_grad=True)
    torch.sin(tnet(tx)).sum().backward()
    tgrads = {k: p.grad.numpy() for k, p in tnet.named_parameters()}
    for fn in (loss_apply, loss_fused):
        gp, gx = jax.jit(jax.grad(fn, argnums=(0, 1)))(params,
                                                        jnp.asarray(x))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                                   rtol=2e-4, atol=2e-4)
        for k, g in flatten_tree(_np(gp)).items():
            np.testing.assert_allclose(tgrads[k], g.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=k)


@pytest.mark.parametrize("shape,k", [((16, 8, 4), 8), ((7, 13), 3)])
def test_mixture_gradients_match_reference(shape, k):
    """Autograd of the numerics (the mixture backward kernel's plain
    version) against ``jax.grad`` of the reference's
    ``mixture_logit_cdf_and_ldj``, log-scales on both sides of the clip."""
    r = np.random.default_rng(4)
    n = lambda *s: r.standard_normal(s).astype(np.float32)
    ins = [n(*shape) * 2, n(*shape, k), n(*shape, k) * 2,
           n(*shape, k) * 4 - 0.5]
    gy, gl = n(*shape), n(*shape)

    def jloss(*a):
        y, ldj = jnm.mixture_logit_cdf_and_ldj(*a)
        return jnp.sum(y * gy) + jnp.sum(ldj * gl)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, ins))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    y, ldj = nm.mixture_logit_cdf_and_ldj(*tins)
    got = torch.autograd.grad((y * torch.tensor(gy)).sum()
                              + (ldj * torch.tensor(gl)).sum(), tins)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    clipped = (ins[3] < nm.LOG_SCALE_MIN) | (ins[3] > nm.LOG_SCALE_MAX)
    assert clipped.any() and (got[3].numpy()[clipped] == 0).all()


@pytest.mark.parametrize("name", ["radam", "adam", "sgd"])
def test_optimizer_steps_match_reference(name):
    """Eight updates at the default rate (RAdam's rectified branch starts
    at the sixth), the third with a gradient norm above the clip of 100,
    against the reference's ``OptimizerConfig(...).build()`` to 2e-6.
    (optax computes RAdam's rho in fp32, torch in double: at a rate of 0.05
    the rectified updates differ by up to 2e-5.)"""
    r = np.random.default_rng(5)
    p0 = {"a": r.standard_normal((5, 3)).astype(np.float32),
          "b": r.standard_normal(7).astype(np.float32)}
    grads = [{k: r.standard_normal(v.shape).astype(np.float32)
              * (400.0 if i == 2 else 1.0) for k, v in p0.items()}
             for i in range(8)]
    kw = dict(name=name, warmup_steps=3)
    tx = JaxOptimizerConfig(**kw).build()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    model = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v))
                                    for k, v in p0.items()})
    state = TrainState.create(model, OptimizerConfig(**kw))
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in
                                        g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in model.items():
            p.grad = torch.tensor(g[k])
        norm = state.apply_gradients()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        for k, p in model.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=2e-6, err_msg=k)
    assert state.step == 8


def test_beta_schedules_match_reference():
    specs = [dict(kind="sigmoid", start=0.5, end=1.0, center=2000,
                  rate=0.002),
             dict(kind="sigmoid", start=0.0, end=1.0, center=100, rate=0.1),
             dict(kind="linear", start=0.2, end=0.9, num_steps=50, delay=10),
             dict(kind="constant", value=0.7),
             dict(kind="exponential", value=1e-3, decay_rate=0.5,
                  decay_steps=100)]
    for spec in specs:
        j, t = JaxScheduleSpec(**spec).build(), ScheduleSpec(**spec).build()
        for step in (0, 1, 10, 60, 100, 1999, 2000, 5000, 10**6):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{spec} {step}")
    with pytest.raises(ValueError):
        ScheduleSpec(kind="nope").build()


# -- trainer ----------------------------------------------------------------

def _task():
    return SetShufflingTask(**{**TINY, "hidden_dim": 24, "num_mixtures": 3,
                               "encoding_dim": 2, "compute_dtype": "float32"},
                            device="cpu")


def _cfg(out_dir, num_steps=60, **kw):
    return TrainConfig(num_steps=num_steps, eval_every=30, eval_samples=2,
                       final_eval_samples=2, log_every=20, out_dir=out_dir,
                       seed=3, optimizer=OptimizerConfig(learning_rate=3e-3),
                       beta_schedule=ScheduleSpec(kind="constant", value=1.0),
                       **kw)


def test_trainer_lowers_bpd_then_resumes(tmp_path, capsys):
    """60 tiny steps lower the fp32 IS bpd by 0.2 bits; a resume from the
    run directory continues the step count and re-evaluates the best."""
    out = str(tmp_path / "run")
    task = _task()
    trainer = Trainer(task, _cfg(out))
    # the model train() starts from: the seed's parameters, data-initialised
    # on the first training batch
    trainer.init_model(next(task.train_batches(np.random.default_rng(3))))
    bpd0 = trainer.evaluate(2, 0)["bpd"]
    start = {k: v.clone() for k, v in task.model.state_dict().items()}
    started_from = []
    init_model = trainer.init_model

    def spy(batch):
        init_model(batch)
        started_from.append({k: v.clone() for k, v in
                             task.model.state_dict().items()})

    trainer.init_model = spy
    final = trainer.train(resume=False)
    assert len(started_from) == 1 and all(
        torch.equal(started_from[0][k], v) for k, v in start.items())
    assert np.isfinite(final["best_bpd"])
    assert final["best_bpd"] < bpd0 - 0.2, (final, bpd0)
    assert final["best_bpd"] > task.analytic_optimum_bpd()
    assert trainer.state.step == 60
    for key in ("permutation_validity", "test_bpd", "test_gap_to_optimum"):
        assert key in final
    rows = [json.loads(line) for line in open(os.path.join(out,
                                                           "metrics.jsonl"))]
    assert {r["prefix"] for r in rows} == {"train", "val", "test", "final"}
    assert all({"step", "time", "prefix"} <= set(r) for r in rows)
    assert [r["step"] for r in rows if r["prefix"] == "train"] == [20, 40, 60]
    assert os.listdir(os.path.join(out, "checkpoints_last")) == [
        "step_00000060.pt"]

    capsys.readouterr()
    resumed = Trainer(_task(), _cfg(out, num_steps=80))
    final2 = resumed.train(resume=True)
    assert "resumed from step 60" in capsys.readouterr().out
    assert resumed.state.step == 80
    assert np.isfinite(final2["best_bpd"])
    assert final2["best_bpd"] <= final["best_bpd"] + 0.5
    rows = [json.loads(line) for line in open(os.path.join(out,
                                                           "metrics.jsonl"))]
    assert max(r["step"] for r in rows if r["prefix"] == "train") == 80


def test_sigterm_finishes_the_step_and_runs_the_final_phase(tmp_path):
    out = str(tmp_path / "run")
    task = _task()
    batches = task.train_batches

    def signalling(rng):
        for i, b in enumerate(batches(rng)):
            if i == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    task.train_batches = signalling
    trainer = Trainer(task, _cfg(out, num_steps=40))
    final = trainer.train(resume=False)
    step = trainer.state.step
    assert final["preempted"] == 1.0 and 0 < step < 40
    assert "test_bpd" in final and "permutation_validity" in final
    assert os.listdir(os.path.join(out, "checkpoints_last")) == [
        f"step_{step:08d}.pt"]
    assert signal.getsignal(signal.SIGTERM) is not None


def test_trainer_refuses_what_is_not_ported():
    """An LM backbone that neither package has is refused, by name; the
    reference's two (the LSTM and the causal transformer) build; a
    steps_per_call below 1 is refused."""
    from categoricalnf_tpu_torch.networks import CausalTransformer
    from categoricalnf_tpu_torch.tasks import LanguageModelingTask
    tiny = dict(corpus_name="synthetic", seq_len=8, encoding_dim=2,
                num_layers=1, hidden_dim=8, lstm_layers=1, num_mixtures=2,
                device="cpu")
    with pytest.raises(ValueError, match="unknown LM net 'gru'"):
        LanguageModelingTask(**tiny, net="gru")
    task = LanguageModelingTask(**tiny, net="transformer")
    nets = [m for m in task.model.modules()
            if isinstance(m, CausalTransformer)]
    assert len(nets) == 2 and all(n.max_len == 8 for n in nets)
    with pytest.raises(ValueError, match="steps_per_call"):
        Trainer(_task(), _cfg(None, steps_per_call=0))


def test_checkpoint_retention_and_contents(tmp_path):
    from categoricalnf_tpu_torch.training.checkpoint import CheckpointManager
    task = _task()
    state = TrainState.create(task.model, OptimizerConfig())
    m = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        m.save(step, task.model, optimizer=state.optimizer,
               metrics={"bpd": 4.0 - step})
    assert m.steps() == [2, 3]
    assert sorted(os.listdir(m.dir)) == [
        "step_00000002.metrics.json", "step_00000002.pt",
        "step_00000003.metrics.json", "step_00000003.pt"]
    with open(os.path.join(m.dir, "step_00000003.metrics.json")) as f:
        assert json.load(f) == {"bpd": 1.0}
    restored = m.restore_latest()
    assert restored["step"] == 3 and "optimizer" in restored
    state.load_state_dict(restored)
    assert state.step == 3


def test_cli_writes_a_run_that_load_run_serves(tmp_path):
    from categoricalnf_tpu_torch.experiments.set_shuffling import main
    from categoricalnf_tpu_torch.inference import load_run
    from categoricalnf_tpu_torch.utils.cli import check_resume_args
    out = str(tmp_path / "run")
    argv = ["--num_steps", "6", "--eval_every", "3", "--eval_samples", "1",
            "--batch_size", "8", "--set_size", "6", "--num_layers", "2",
            "--hidden_dim", "16", "--num_mixtures", "2", "--encoding_dim",
            "2", "--log_every", "3", "--out_dir", out, "--fused", "--remat"]
    final = main(argv + ["--device", "cpu"])
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["task"] == "set_shuffling" and cfg["args"]["set_size"] == 6
    handle = load_run(out, device="cpu")
    assert handle.step in (3, 6)
    x = handle.sample(4, 6, seed=1)
    assert x.shape == (4, 6) and x.min() >= 0 and x.max() < 6
    assert np.isfinite(handle.eval_bpd({"x": x}, num_samples=2)).all()
    assert np.isfinite(final["best_bpd"])
    with pytest.raises(ValueError, match="architecture"):
        check_resume_args(out, {**cfg["args"], "hidden_dim": 32})
    check_resume_args(out, {**cfg["args"], "lr": 1.0})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_port_imports_no_jax_covers_the_training_slice():
    sources = {os.path.relpath(p, test_torch_slice.REPO)
               for p in test_torch_slice._port_sources()}
    for mod in ("training/engine.py", "training/state.py",
                "training/schedules.py", "training/metrics.py",
                "training/checkpoint.py", "data/prefetch.py", "utils/cli.py",
                "experiments/set_shuffling.py"):
        assert os.path.join("categoricalnf_tpu_torch", mod) in sources, mod
    test_torch_slice.test_port_imports_no_jax()
