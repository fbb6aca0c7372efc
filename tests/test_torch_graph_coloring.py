"""The port's graph-coloring slice against the JAX package, on the CPU.

The RGCN coupling net (``adj`` and ``adj_r``, masked, fp32 and bf16), the
numpy generator, validity check and repair pass (bit for bit), and a tiny
``GraphColoringTask`` (hidden 16, a scanned stack of depth 2 = 4 layers,
D = 4, graphs of 4-8 nodes, batch 8) end to end: loss, IS bits/var and a
sample with shared noise, on the reference's weights carried across by
``convert.from_jax_params``.  Then the port's own surfaces on the CPU: the
sample-metric columns, a checkpoint round trip, the CLI, the HTTP payload,
and a dict ``cond`` through the batch plumbing.
"""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.networks.graph import RGCN as JaxRGCN
from categoricalnf_tpu.tasks import graph_coloring as jgc
from categoricalnf_tpu_torch import flows as tflows
from categoricalnf_tpu_torch.convert import flatten_tree, from_jax_params
from categoricalnf_tpu_torch.networks import RGCN
from categoricalnf_tpu_torch.tasks import graph_coloring as tgc

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

TINY = dict(min_nodes=4, max_nodes=8, batch_size=8, encoding_dim=4,
            num_layers=4, hidden_dim=16, num_mixtures=4,
            eval_batches_count=1, compute_dtype="float32")
B, N, D = 8, 8, 4
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _graph_cond(r, relations):
    """A random symmetric adjacency, or one-hot relations of it."""
    e = r.integers(0, relations + 1, (B, N, N)) * (r.random((B, N, N)) < 0.4)
    e = np.triu(e, 1)
    e = e + e.transpose(0, 2, 1)
    if relations == 1:
        return {"adj": e.astype(np.float32)}
    return {"adj_r": np.eye(relations + 1, dtype=np.float32)[e][..., 1:]}


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("relations", [1, 2], ids=["adj", "adj_r"])
def test_rgcn_matches_reference(relations, cd):
    """Masked RGCN on the reference's weights (random output layer).  fp32
    within 1e-5.  bf16 within 2 bf16 ulps at the output's scale (2^-6 of
    its largest magnitude): the two frameworks round the bf16 residual
    stream after the same operations, but sum the fp32 contractions in
    another order and evaluate the bf16 gelu with another rounding, so a
    rounding of an activation can flip; the worst reading is 1.25 ulps."""
    r = np.random.default_rng(relations)
    j = JaxRGCN(hidden_dim=16, num_layers=2, num_relations=relations,
                compute_dtype=cd)
    params = _np(j.init(jax.random.PRNGKey(0), D, 40))
    for k in ("w", "b"):
        params["out"][k] = (r.standard_normal(params["out"][k].shape)
                            * 0.1).astype(np.float32)
    net = RGCN(D, 40, hidden_dim=16, num_layers=2, num_relations=relations,
               compute_dtype=cd)
    net.load_state_dict(flatten_tree(params))
    x = r.standard_normal((B, N, D)).astype(np.float32)
    mask = (np.arange(N)[None] < r.integers(4, N + 1, (B, 1))).astype(
        np.float32)
    cond = _graph_cond(r, relations)
    want = np.asarray(j.apply(params, jnp.asarray(x),
                              cond=jax.tree.map(jnp.asarray, cond),
                              mask=jnp.asarray(mask))).astype(np.float32)
    with torch.no_grad():
        got = net(torch.tensor(x), cond=jax.tree.map(torch.tensor, cond),
                  mask=torch.tensor(mask))
    assert got.dtype == getattr(torch, cd)
    tol = 1e-5 if cd == "float32" else 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol)


def test_rgcn_respects_adjacency():
    """A node's output depends on its neighbours, not on other nodes."""
    net = RGCN(4, 8, hidden_dim=16, num_layers=1,
               generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape,
                                    generator=torch.Generator()
                                    .manual_seed(1)) * 0.1)
        x = torch.randn(1, 6, 4, generator=torch.Generator().manual_seed(2))
        adj = torch.zeros(1, 6, 6)
        adj[0, 0, 1] = adj[0, 1, 0] = 1.0  # the only edge: 0-1
        out1 = net(x, cond={"adj": adj})
        x2 = x.clone()
        x2[0, 5] += 10.0                   # an isolated node
        out2 = net(x2, cond={"adj": adj})
        torch.testing.assert_close(out1[0, :5], out2[0, :5], rtol=0,
                                   atol=1e-5)
        x3 = x.clone()
        x3[0, 1] += 10.0                   # node 0's neighbour
        out3 = net(x3, cond={"adj": adj})
    assert not torch.allclose(out1[0, 0], out3[0, 0])


def test_numpy_helpers_match_reference_bit_for_bit():
    for seed in range(3):
        a1, c1 = jgc.random_colorable_graph(np.random.default_rng(seed), 12)
        a2, c2 = tgc.random_colorable_graph(np.random.default_rng(seed), 12)
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(c1, c2)
    jt = jgc.GraphColoringTask(**TINY)
    tt = tgc.GraphColoringTask(**TINY, device="cpu")
    jb, tb = (t._gen(np.random.default_rng(5), 32) for t in (jt, tt))
    for k in ("x", "mask"):
        np.testing.assert_array_equal(jb[k], tb[k])
        assert jb[k].dtype == tb[k].dtype
    adj, mask = jb["cond"]["adj"], jb["mask"]
    np.testing.assert_array_equal(adj, tb["cond"]["adj"])
    r = np.random.default_rng(6)
    colors = r.integers(0, 3, mask.shape)
    probs = r.random(mask.shape + (3,))
    np.testing.assert_array_equal(jgc.coloring_validity(adj, colors, mask),
                                  tgc.coloring_validity(adj, colors, mask))
    fixed = tgc.repair_coloring(adj, probs, colors, mask, seed=3)
    np.testing.assert_array_equal(
        jgc.repair_coloring(adj, probs, colors, mask, seed=3), fixed)
    assert tgc.coloring_validity(adj, fixed, mask).mean() >= \
        tgc.coloring_validity(adj, colors, mask).mean()
    for a, b in zip(jt.eval_batches(), tt.eval_batches()):
        np.testing.assert_array_equal(a["cond"]["adj"], b["cond"]["adj"])


def _tiny_pair():
    """The tiny task in both frameworks; the reference's data-initialised
    weights, its coupling output layers random, carried across."""
    jtask = jgc.GraphColoringTask(**TINY)
    batch = jtask._gen(np.random.default_rng(0), B)
    jbatch = jax.tree.map(jnp.asarray, batch)
    params = _np(jax.jit(jtask.data_init)(
        jax.jit(jtask.init_params)(jax.random.PRNGKey(0)), jbatch,
        jax.random.PRNGKey(1)))
    (stack,) = params["flow"]
    r = np.random.default_rng(2)
    for li in (2, 6):
        for k in ("w", "b"):
            v = stack[li]["net"]["out"][k]
            stack[li]["net"]["out"][k] = (r.standard_normal(v.shape)
                                          * 0.1).astype(np.float32)
    ttask = tgc.GraphColoringTask(**TINY, device="cpu")
    (scan,) = ttask.model.flow.layers
    assert isinstance(scan, tflows.ScannedBlocks) and len(scan.blocks) == 2
    ttask.model.load_state_dict(from_jax_params(ttask, params))
    return jtask, params, ttask, batch, jbatch


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                         minval=1e-6, maxval=1.0 - 1e-6))


def test_tiny_task_matches_reference():
    """Loss (its encoder's uniforms shared), the IS bits/var of 4 chains
    and a sample with shared prior noise: within 1e-4; the decoded colors
    equal."""
    jtask, params, ttask, batch, jbatch = _tiny_pair()
    key = jax.random.PRNGKey(9)
    jloss = float(jax.jit(jtask.loss)(params, jbatch, key, 0.8))
    with torch.no_grad():
        tloss = float(ttask.loss(batch, 0.8,
                                 noise=torch.tensor(_uniform(key, (B, N, D)))))
    np.testing.assert_allclose(tloss, jloss, rtol=TOL, atol=TOL)

    S = 4
    noise = np.stack([_uniform(k, (B, N, D))
                      for k in jax.random.split(key, S)])
    jbpd = np.asarray(jax.jit(jtask.eval_step, static_argnums=3)(
        params, jbatch, key, S))
    tbpd = ttask.eval_step(batch, S, noise=torch.tensor(noise)).numpy()
    np.testing.assert_allclose(tbpd, jbpd, rtol=TOL, atol=TOL)
    assert np.isfinite(tbpd).all() and (tbpd > 0).all()

    u = _uniform(jax.random.PRNGKey(10), (B, N, D))

    @jax.jit
    def jsample(p, zk, adj, mask):
        z, _ = jtask.model.flow.inverse(p["flow"], zk, cond={"adj": adj},
                                        mask=mask)
        return z, jtask.model.encoding.decode(p["encoding"], z, mask=mask)

    jz, jx = jsample(params, jnp.log(u) - jnp.log1p(-u),
                     jbatch["cond"]["adj"], jbatch["mask"])
    with torch.no_grad():
        tz = ttask.model.flow.sample(
            (B, N, D), cond=ttask._tensor(batch["cond"]),
            mask=ttask._tensor(batch["mask"]), noise=torch.tensor(u))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=TOL,
                               atol=TOL)
    with torch.no_grad():
        tx, post = (ttask.model.encoding.decode(tz),
                    ttask.model.encoding.posterior(tz))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(
        post.numpy(),
        np.asarray(jtask.model.encoding.posterior(params["encoding"], jz)),
        rtol=TOL, atol=TOL)


def test_from_jax_params_splits_and_checks_scanned_trees():
    jtask, params, ttask, _, _ = _tiny_pair()
    state = from_jax_params(ttask, params)
    (stack,) = params["flow"]
    np.testing.assert_array_equal(
        state["flow.layers.0.blocks.1.2.net.blocks.0.self.w"].numpy(),
        stack[2]["net"]["blocks"][0]["self"]["w"][1])
    # a block without its last coupling, and a deeper stack, both refused
    for other in (stack[:-2],
                  jax.tree.map(lambda a: np.concatenate([a, a[:1]]), stack)):
        with pytest.raises(ValueError, match="differ"):
            from_jax_params(ttask, {**params, "flow": (other,)})
    # a stack whose leaves are of another width
    wide = jax.tree.map(lambda a: np.concatenate([a, a], axis=-1), stack)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(ttask, {**params, "flow": (wide,)})


def test_sample_metrics_columns():
    task = tgc.GraphColoringTask(**TINY, device="cpu")
    g = torch.Generator().manual_seed(0)
    m = task.sample_metrics(generator=g, num_samples=12)
    assert set(m) == {"coloring_validity", "coloring_validity_ci95",
                      "coloring_validity_corrected",
                      "coloring_validity_corrected_ci95",
                      "metric_num_samples"}
    assert m["metric_num_samples"] == 12.0
    assert 0.0 <= m["coloring_validity"] <= m["coloring_validity_corrected"]
    assert m["coloring_validity_corrected"] <= 1.0
    mk = task.sample_metrics(generator=g, num_samples=12, best_of_k=3)
    assert mk["best_of_k"] == 3.0
    assert mk["coloring_validity_at_k"] >= mk["coloring_validity"]
    assert "coloring_validity_at_k_ci95" in mk


def _cpu_run(tmp_path):
    from categoricalnf_tpu_torch.training.checkpoint import CheckpointManager
    from categoricalnf_tpu_torch.utils.config import save_config
    out = str(tmp_path / "run")
    task = tgc.GraphColoringTask(**TINY, device="cpu")
    task.data_init(next(task.train_batches(np.random.default_rng(0))),
                   generator=torch.Generator().manual_seed(0))
    save_config(out, {"task": task.name, "args": {**TINY, "seed": 3}})
    CheckpointManager(out).save(5, task.model)
    return out, task


def test_checkpoint_round_trip(tmp_path):
    from categoricalnf_tpu_torch.inference import load_run
    out, task = _cpu_run(tmp_path)
    handle = load_run(out, device="cpu")
    assert handle.step == 5 and handle.task.name == "graph_coloring"
    want = task.model.state_dict()
    got = handle.task.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def _post(conn, path, body):
    conn.request("POST", path, body=json.dumps(body))
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_serve_sample_payload(tmp_path):
    """/sample gives graphs with colors on their live nodes; ``valid`` is
    the validity recomputed from the payload; /sample_metrics passes
    through to the task."""
    from categoricalnf_tpu_torch.serve import RunServer, make_handler
    run_dir, _ = _cpu_run(tmp_path)
    server = RunServer(run_dir, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_port,
                                          timeout=120)
        conn.request("GET", "/health")
        assert json.loads(conn.getresponse().read())["task"] == \
            "graph_coloring"
        st, out = _post(conn, "/sample", {"num_samples": 4})
        assert st == 200 and len(out["samples"]) == 4
        for s in out["samples"]:
            k = len(s["colors"])
            assert TINY["min_nodes"] <= k <= TINY["max_nodes"]
            assert all(0 <= c < 3 for c in s["colors"])
            adj = np.zeros((1, k, k), np.float32)
            for i, j in s["edges"]:
                assert 0 <= i < j < k
                adj[0, i, j] = adj[0, j, i] = 1.0
            assert s["valid"] == bool(tgc.coloring_validity(
                adj, np.asarray([s["colors"]]), np.ones((1, k)))[0])
        st, m = _post(conn, "/sample_metrics", {"num_samples": 10})
        assert st == 200 and m["metric_num_samples"] == 10.0
        assert m["coloring_validity_corrected"] >= m["coloring_validity"]
        st, out = _post(conn, "/sample", {"num_samples": 0})
        assert st == 400 and "error" in out
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_cli_trains_a_run_that_load_run_serves(tmp_path):
    from categoricalnf_tpu_torch.experiments.graph_coloring import main
    from categoricalnf_tpu_torch.inference import load_run
    out = str(tmp_path / "run")
    final = main(["--num_steps", "4", "--eval_every", "2", "--eval_samples",
                  "2", "--batch_size", "32", "--min_nodes", "4",
                  "--max_nodes", "6", "--num_layers", "4", "--hidden_dim",
                  "8", "--num_mixtures", "2", "--log_every", "2",
                  "--out_dir", out, "--device", "cpu"])
    assert np.isfinite(final["best_bpd"]) and final["best_bpd"] > 0
    assert final["metric_num_samples"] == 1024.0
    assert 0.0 <= final["coloring_validity"] <= 1.0
    cfg = json.load(open(f"{out}/config.json"))
    assert cfg["task"] == "graph_coloring" and cfg["args"]["batch_size"] == 32
    assert cfg["args"]["encoding_dim"] == 2
    handle = load_run(out, device="cpu")
    assert handle.step in (2, 4) and handle.task.max_nodes == 6


def test_dict_cond_goes_through_the_batch_plumbing(monkeypatch):
    from categoricalnf_tpu_torch.data.prefetch import pin, to_device
    from categoricalnf_tpu_torch.models.categorical_flow import _tile
    task = tgc.GraphColoringTask(**TINY, device="cpu")
    batch = task._gen(np.random.default_rng(0), 3)
    # pinning needs a card; its nesting is what is held here
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t: t)
    for moved in (pin(batch), to_device(batch, "cpu"),
                  to_device(pin(batch), "cpu")):
        assert set(moved) == {"x", "mask", "cond"}
        assert isinstance(moved["cond"], dict)
        np.testing.assert_array_equal(moved["cond"]["adj"].numpy(),
                                      batch["cond"]["adj"])
    cond = task._tensor(batch["cond"])
    assert cond["adj"].dtype == torch.float32
    tiled = _tile(cond, 2)
    assert torch.equal(tiled["adj"], torch.cat([cond["adj"]] * 2))
    x = torch.zeros(3, 4)
    assert torch.equal(_tile(x, 2), torch.zeros(6, 4)) and _tile(None, 2) \
        is None
