"""The port's serving slice against the JAX package, on the CPU.

Flow layers one by one, then a tiny set-shuffling task end to end (sample,
ELBO, IS bits/var) on shared weights (carried across by
``convert.from_jax_params``) and shared noise; the port's HTTP server on a
CPU run directory; the rule that the port imports no JAX; and the rule that
its entry points need a card unless told ``device="cpu"``.
"""

import ast
import http.client
import json
import os
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu import flows as jflows
from categoricalnf_tpu.networks.transformer import \
    SetTransformer as JaxSetTransformer
from categoricalnf_tpu.tasks.set_modeling import \
    SetShufflingTask as JaxSetShufflingTask
from categoricalnf_tpu_torch import flows as tflows
from categoricalnf_tpu_torch.convert import flatten_tree, from_jax_params
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.tasks import SetShufflingTask

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(set_size=6, batch_size=16, num_layers=2, hidden_dim=24,
            num_mixtures=3, encoding_dim=2, compute_dtype="float32")
B, T, D = 16, 6, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _z(seed, shape=(B, T, D), scale=1.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _randomize_net_out(net_params, seed):
    """A zero-initialised output layer makes the coupling the identity."""
    r = np.random.default_rng(seed)
    out = net_params["out"]
    out["w"] = (r.standard_normal(out["w"].shape) * 0.1).astype(np.float32)
    out["b"] = (r.standard_normal(out["b"].shape) * 0.1).astype(np.float32)


def _run_both(jlayer, jparams, tlayer, z, mask=None):
    zero = np.zeros(z.shape[0], np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    out = {}
    for name in ("forward", "inverse"):
        jz, jl = getattr(jlayer, name)(jparams, jnp.asarray(z), zero,
                                       mask=jm)
        with torch.no_grad():
            tz, tl = getattr(tlayer, name)(torch.tensor(z),
                                           torch.tensor(zero), mask=tm)
        out[name] = (np.asarray(jz), np.asarray(jl), tz.numpy(), tl.numpy())
    return out


def _layer_cases():
    key = jax.random.PRNGKey(3)
    an = jflows.ActNorm()
    an_p = {"bias": np.float32([0.3, -0.2]),
            "log_scale": np.float32([0.4, -0.7])}
    t_an = tflows.ActNorm(D)
    il = jflows.InvertibleLinear()
    il_p = _np(il.init(key, D))
    t_il = tflows.InvertibleLinear(D)
    sc = jflows.SoftClamp()
    t_sc = tflows.SoftClamp()
    net = JaxSetTransformer(hidden_dim=24, num_heads=4, num_layers=2,
                            compute_dtype="float32")
    cp = jflows.MixtureCDFCoupling(net=net, parity=1, num_mixtures=3)
    cp_p = _np(cp.init(key, D))
    _randomize_net_out(cp_p["net"], 4)
    t_cp = tflows.MixtureCDFCoupling(
        SetTransformer(D, D * 11, hidden_dim=24, num_heads=4,
                       compute_dtype="float32"), D, parity=1, num_mixtures=3)
    return {"actnorm": (an, an_p, t_an), "linear": (il, il_p, t_il),
            "softclamp": (sc, {}, t_sc), "coupling": (cp, cp_p, t_cp)}


@pytest.mark.parametrize("name", ["actnorm", "linear", "softclamp",
                                  "coupling"])
@pytest.mark.parametrize("masked", [False, True])
def test_flow_layer_matches_reference(name, masked):
    """(d) forward and inverse: z and ldj to 1e-5 (1e-4 for the coupling's
    root-find), with and without a position mask."""
    jlayer, jp, tlayer = _layer_cases()[name]
    tlayer.load_state_dict(flatten_tree(jp))
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[:, -2:] = 0
    tol = 1e-4 if name == "coupling" else 1e-5
    for jz, jl, tz, tl in _run_both(jlayer, jp, tlayer, _z(5), mask).values():
        np.testing.assert_allclose(tz, jz, rtol=tol, atol=tol)
        np.testing.assert_allclose(tl, jl, rtol=tol, atol=tol)


@pytest.mark.parametrize("masked", [False, True])
def test_actnorm_data_init_matches_reference(masked):
    """(d) masked statistics, biased variance, arctanh of the tanh cap."""
    z = _z(6) + 0.7
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[::2, -3:] = 0
    jp, jz = jflows.ActNorm().data_init(
        {"bias": np.zeros(D, np.float32), "log_scale": np.zeros(D, np.float32)},
        jnp.asarray(z), mask=None if mask is None else jnp.asarray(mask))
    t = tflows.ActNorm(D)
    tz = t.data_init(torch.tensor(z),
                     mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t.bias.detach().numpy(),
                               np.asarray(jp["bias"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.log_scale.detach().numpy(),
                               np.asarray(jp["log_scale"]), rtol=1e-5,
                               atol=1e-5)


def _tiny_pair():
    """The same tiny flagship-shaped task in both frameworks, with the
    reference's data-initialised weights carried across."""
    jtask = JaxSetShufflingTask(**TINY)
    key = jax.random.PRNGKey(0)
    x = np.argsort(np.random.default_rng(7).random((B, T)), axis=1)
    params = jtask.data_init(jtask.init_params(key), {"x": jnp.asarray(x)},
                             jax.random.PRNGKey(1))
    params = _np(params)
    for i, layer in enumerate(jtask.model.flow.layers):
        if isinstance(layer, jflows.MixtureCDFCoupling):
            _randomize_net_out(params["flow"][i]["net"], 10 + i)
    ttask = SetShufflingTask(**TINY, device="cpu")
    ttask.model.load_state_dict(from_jax_params(ttask, params))
    return jtask, params, ttask, x


def test_sample_matches_reference():
    """(e) the same prior noise through the JAX flow.inverse + decode and
    the port's sample(noise=...): z to 1e-4, categories equal."""
    jtask, params, ttask, _ = _tiny_pair()
    u = np.random.default_rng(8).uniform(1e-6, 1 - 1e-6, (B, T, D)).astype(
        np.float32)
    zk = jnp.log(u) - jnp.log1p(-u)
    jz, _ = jax.jit(jtask.model.flow.inverse)(params["flow"], zk)
    jx = np.asarray(jtask.model.encoding.decode(params["encoding"], jz))
    with torch.no_grad():
        tz = ttask.model.flow.sample((B, T, D), noise=torch.tensor(u))
        tx = ttask.model.sample(B, T, noise=torch.tensor(u))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tx.numpy(), jx)


def test_elbo_and_eval_bpd_match_reference():
    """(e) the same encoder noise through both ELBOs: log_pz, log_dec and
    log_q to 1e-4 relative; the IS bits/var of the fp32 twin likewise."""
    jtask, params, ttask, x = _tiny_pair()
    key = jax.random.PRNGKey(9)
    parts = jax.jit(jtask.model.elbo)(params, jnp.asarray(x), key)
    # JAX's encoder draws exactly this uniform from ``key``
    u = np.asarray(jax.random.uniform(key, (B, T, D), jnp.float32,
                                      minval=1e-6, maxval=1.0 - 1e-6))
    with torch.no_grad():
        tparts = ttask.model.elbo(torch.tensor(x), noise=torch.tensor(u))
    for k in ("log_pz", "log_dec", "log_q", "elbo"):
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(parts[k]),
                                   rtol=1e-4, atol=1e-4)

    S = 4
    keys = jax.random.split(key, S)
    noise = np.stack([np.asarray(jax.random.uniform(
        k, (B, T, D), jnp.float32, minval=1e-6, maxval=1.0 - 1e-6))
        for k in keys])
    jbpd = np.asarray(jax.jit(jtask.eval_step, static_argnums=3)(
        params, {"x": jnp.asarray(x)}, key, S))
    tbpd = ttask.eval_step({"x": x}, S, noise=torch.tensor(noise)).numpy()
    np.testing.assert_allclose(tbpd, jbpd, rtol=1e-4, atol=1e-4)
    assert (tbpd > ttask.analytic_optimum_bpd()).all()


def test_eval_twin_shares_parameters():
    """The fp32 twin runs fp32 nets on the very same parameter tensors."""
    task = SetShufflingTask(**{**TINY, "compute_dtype": "bfloat16"},
                            device="cpu")
    twin = task.eval_model
    nets = [m for m in twin.modules() if isinstance(m, SetTransformer)]
    assert nets and all(n.compute_dtype == "float32" for n in nets)
    assert all(m.compute_dtype == "bfloat16" for m in task.model.modules()
               if isinstance(m, SetTransformer))
    sd = {k: v + 1.0 for k, v in task.model.state_dict().items()}
    task.model.load_state_dict(sd)
    for k, v in twin.state_dict().items():
        assert torch.equal(v, sd[k])


def test_from_jax_params_rejects_other_trees():
    jtask, params, ttask, _ = _tiny_pair()
    params["flow"] = params["flow"][:-2]
    with pytest.raises(ValueError, match="differ"):
        from_jax_params(ttask, params)


def _cpu_run(tmp_path):
    from categoricalnf_tpu_torch.training.checkpoint import CheckpointManager
    from categoricalnf_tpu_torch.utils.config import save_config
    out = str(tmp_path / "run")
    task = SetShufflingTask(**TINY, device="cpu")
    task.data_init(next(task.train_batches(np.random.default_rng(0))),
                   generator=torch.Generator().manual_seed(0))
    save_config(out, {"task": task.name, "args": TINY})
    CheckpointManager(out).save(3, task.model)
    return out, task


def test_checkpoint_round_trip(tmp_path):
    from categoricalnf_tpu_torch.inference import load_run
    out, task = _cpu_run(tmp_path)
    handle = load_run(out, device="cpu")
    assert handle.step == 3
    for k, v in task.model.state_dict().items():
        assert torch.equal(handle.task.model.state_dict()[k], v)


@pytest.mark.parametrize("fused", [True, False])
def test_saved_fused_flag_restores_the_same_model(tmp_path, fused):
    """The reference's ``fused`` flag in a saved config is dropped: the
    device alone picks the kernel, so both values restore one model."""
    from categoricalnf_tpu_torch.inference import build_task, load_run
    from categoricalnf_tpu_torch.utils.config import save_config
    out, task = _cpu_run(tmp_path)
    save_config(out, {"task": task.name, "args": {**TINY, "fused": fused}})
    handle = load_run(out, device="cpu")
    assert not hasattr(handle.task, "fused")
    for k, v in task.model.state_dict().items():
        assert torch.equal(handle.task.model.state_dict()[k], v)
    assert build_task("set_shuffling", {**TINY, "fused": fused},
                      device="cpu").model.state_dict().keys() == \
        task.model.state_dict().keys()


def test_serve_endpoints(tmp_path):
    """(f) the port's RunServer on a CPU run directory."""
    from categoricalnf_tpu_torch.serve import (RunServer, _sample_payload,
                                               make_handler)
    run_dir, _ = _cpu_run(tmp_path)
    server = RunServer(run_dir, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_port,
                                          timeout=120)
        conn.request("GET", "/health")
        r = conn.getresponse()
        health = json.loads(r.read())
        assert r.status == 200 and health == {"status": "ok",
                                              "task": "set_shuffling",
                                              "step": 3}
        conn.request("GET", "/info")
        assert json.loads(conn.getresponse().read())["args"]["set_size"] == 6
        conn.request("POST", "/sample",
                     body=json.dumps({"num_samples": 4, "temperature": 0.9}))
        r = conn.getresponse()
        samples = np.asarray(json.loads(r.read())["samples"])
        assert r.status == 200 and samples.shape == (4, 6)
        assert samples.dtype.kind == "i"
        assert samples.min() >= 0 and samples.max() < 6
        conn.request("POST", "/sample_metrics",
                     body=json.dumps({"num_samples": 64}))
        m = json.loads(conn.getresponse().read())
        assert m["metric_num_samples"] == 64.0
        assert 0.0 <= m["permutation_validity"] <= 1.0
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
        conn.request("POST", "/sample", body=json.dumps({"num_samples": 0}))
        r = conn.getresponse()
        assert r.status == 400 and "error" in json.loads(r.read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    with pytest.raises(ValueError, match="no sample payload"):
        _sample_payload(object(), None, 4, 1.0)


def _port_sources():
    root = os.path.join(REPO, "categoricalnf_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    # the parallel tests' workers start in processes of their own
    yield os.path.join(REPO, "tests", "_torch_parallel_workers.py")
    for tool in ("fused_ab.py", "mixture_ab.py", "f32_forward_rounding.py",
                 "f32_bwd_tf32x3.py", "dp_check.py"):
        yield os.path.join(REPO, "tools", tool)


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return (top.startswith("jax") or top == "optax" or top.startswith("orbax")
            or top == "categoricalnf_tpu")


def test_port_imports_no_jax():
    """(g) no module of the port, no chip_smoke.py and not the parallel
    tests' workers import JAX, optax, orbax or anything of the JAX
    package."""
    sources = list(_port_sources())
    assert len(sources) > 20
    # the molecule slice's modules, the causal transformer and the
    # parallel layer among them
    names = {os.path.relpath(p, REPO) for p in sources}
    assert {f"categoricalnf_tpu_torch/{m}.py" for m in (
        "tasks/chem", "data/smiles", "networks/graph", "models/graphcnf",
        "tasks/molecules", "experiments/molecule_generation",
        "networks/causal_transformer", "parallel/__init__", "parallel/mesh",
        "parallel/eval")} <= names
    assert "tests/_torch_parallel_workers.py" in names
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _banned(n)]
    assert not bad, bad
    assert not _banned("categoricalnf_tpu_torch.ops")
    assert _banned("categoricalnf_tpu.data.native_loader")


def test_entry_points_need_a_card_unless_told(tmp_path):
    """(h) without device=, build_task and load_run raise on a machine
    without a card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from categoricalnf_tpu_torch.inference import build_task, load_run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task("set_shuffling", TINY)
    run_dir, _ = _cpu_run(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_run(run_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SetShufflingTask(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task("graph_coloring", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task("set_summation", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task("lm_synthetic_markov", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task("molecules_synthetic", {})
    # a named molecule dataset whose .npz is missing raises, on any device
    with pytest.raises(FileNotFoundError, match="zinc250k"):
        build_task("molecules_zinc250k", {"dataset": "zinc250k",
                                          "data_dir": str(tmp_path)},
                   device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_task("no_such_task", {}, device="cpu")
