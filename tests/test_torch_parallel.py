"""The port's parallel layer (``categoricalnf_tpu_torch/parallel/``) on the
CPU: worlds of two ranks over gloo, each rank a process of its own.

The children run ``tests/_torch_parallel_workers.py`` (spawned, one torch
thread each, joined through a ``FileStore`` under the test's temporary
directory or, for the CLI, through the ``CNF_*`` variables); this process
computes the single-process and JAX references and the shared noise, and
kills a world that outlives its time limit, so that a hang fails the tests
of that world only.  Tolerances are the reference's own for its sharded
steps (``tests/test_sharding.py``): the loss within 1e-4, the gradients
within rtol 2e-4 and atol 2e-5; the sharded IS eval within 2e-4.
"""

import multiprocessing as mp
import os
import socket
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from categoricalnf_tpu.ops import numerics as jnm
from categoricalnf_tpu.tasks import molecules as jmol
from categoricalnf_tpu.tasks import set_modeling as jsm
from categoricalnf_tpu_torch.convert import from_jax_params
from categoricalnf_tpu_torch.parallel import Mesh, shard_batch
from categoricalnf_tpu_torch.training.engine import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_workers as W  # noqa: E402

# one intra-op thread: pytest-xdist runs six workers at once
torch.set_num_threads(1)

WORLD_TIMEOUT = 150.0
STEP_CASES = {"set": "set", "molecules": "molecules", "lm_hmm": "lm_hmm",
              "penalty": "set"}
EVAL_CHAINS = 4


class World:
    """``W.<fn>`` started on ``world`` spawned ranks; ``results()`` waits
    for them (until ``timeout`` seconds after the start, then kills the
    ranks still running and fails) and gives their results by rank."""

    def __init__(self, fn: str, world: int, inputs: dict, path, *,
                 store=True, envs=None, timeout: float = WORLD_TIMEOUT):
        path.mkdir(parents=True, exist_ok=True)
        torch.save(inputs, path / "inputs.pt")
        ctx = mp.get_context("spawn")
        self.fn, self.path, self._got = fn, path, None
        self.procs = [ctx.Process(target=W.run, daemon=True, args=(
            r, world, fn, str(path / "inputs.pt"), str(path),
            str(path / "store") if store else None,
            envs[r] if envs else {})) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def results(self) -> list:
        if self._got is None:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            hung = [p for p in self.procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
            errors = "".join(open(self.path / f).read()
                             for f in sorted(os.listdir(self.path))
                             if f.endswith(".err"))
            assert not hung, (f"{self.fn}: {len(hung)} rank(s) still "
                              f"running at the time limit, killed\n{errors}")
            assert all(p.exitcode == 0 for p in self.procs), (
                f"{self.fn} failed:\n{errors}")
            self._got = [torch.load(self.path / f"{r}.pt",
                                    weights_only=False)
                         for r in range(len(self.procs))]
        return self._got


def perturbed(name: str, seed: int):
    """A tiny task, data-initialised on its first training batch, every
    parameter moved by N(0, 0.05^2) so that no gradient is zero by
    construction (the couplings' output layers start at 0)."""
    task = W.build_task(name)
    batch = next(task.train_batches(np.random.default_rng(seed)))
    task.data_init(batch, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in task.model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return task, batch


def _allclose_grads(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


CLI_ARGV = ["--device", "cpu", "--num_steps", "2", "--eval_every", "2",
            "--eval_samples", "1", "--batch_size", "8", "--set_size", "6",
            "--num_layers", "2", "--hidden_dim", "16", "--num_mixtures", "3",
            "--encoding_dim", "2", "--log_every", "1",
            "--compute_dtype", "float32"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of this file, started at once so that they run side by
    side: the one-rank world and the CLI's (two ranks from the ``CNF_*``
    variables) first, then, with the single-process references of its
    cases computed here, the two-rank ``W.steps_world``.  Returns the
    worlds, the references and the CLI's run directory."""
    base = tmp_path_factory.mktemp("worlds")
    address = f"127.0.0.1:{_free_port()}"
    envs = [{"CNF_COORDINATOR_ADDRESS": address, "CNF_NUM_PROCESSES": "2",
             "CNF_PROCESS_ID": str(r)} for r in (0, 1)]
    run_dir = base / "cli_run"
    started = {
        "one": World("one_rank_world", 1, {"dir": str(base / "runs")},
                     base / "one"),
        "cli": World("cli_world", 2,
                     {"argv": CLI_ARGV + ["--out_dir", str(run_dir)]},
                     base / "cli", store=False, envs=envs)}
    rng = np.random.default_rng(0)
    inputs = {"steps": {}, "eval": {}}
    want = {"steps": {}, "eval": {}}
    for case, name in STEP_CASES.items():
        task, batch = perturbed(name, 1)
        noise = W.noise_for(task, batch, rng)
        spec = {"task": name, "state": task.model.state_dict(),
                "batch": batch, "noise": noise}
        if case == "penalty":
            W.offset_elbo(task)
        trainer = Trainer(task, W.train_config())
        loss = trainer.gradients(batch, 0.8, noise=noise)
        want["steps"][case] = {"loss": float(loss.detach()),
                               "grads": W.grads(task.model)}
        if case == "penalty":
            halves = []
            for r in (0, 1):
                rows, part = half_of(batch, noise, r)
                trainer.gradients(rows, 0.8, noise=part)
                halves.append(W.grads(task.model))
            want["steps"][case]["halves"] = halves
            with torch.no_grad():
                want["steps"][case]["elbo"] = float(torch.mean(
                    task.model.elbo(task._tensor(batch["x"], torch.long),
                                    noise=noise)["elbo"]))
        inputs["steps"][case] = spec
    for name in ("set", "molecules"):
        task, _ = perturbed(name, 2)
        batch = task.eval_batches()[0]
        noise = W.noise_for(task, batch, rng, lead=(EVAL_CHAINS,))
        inputs["eval"][name] = {"state": task.model.state_dict(),
                                "batch": batch, "noise": noise,
                                "chains": EVAL_CHAINS}
        want["eval"][name] = task.eval_step(batch, EVAL_CHAINS, noise=noise)
    started["steps"] = World("steps_world", 2, inputs, base / "steps")
    return started, want, run_dir


@pytest.fixture
def steps(worlds):
    """The two-rank steps world's results and the references."""
    return worlds[0]["steps"].results(), worlds[1]


def half_of(batch, noise, rank):
    """Rank ``rank``'s rows of a two-rank data mesh, and their noise."""
    mesh = Mesh(2, 1, rank, None, None, None)
    return shard_batch(mesh, batch), shard_batch(mesh, noise)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_data_parallel_step_matches_single_process(case, steps):
    """One step's loss and gradients on 2 data ranks equal the single
    process's on the whole batch, the global noise sliced to each rank's
    rows, on both ranks: the set task, the masked GraphCNF task, the LM
    with the HMM prior, and the set task with the positive-ELBO penalty
    active."""
    got, want = steps
    for rank in (0, 1):
        np.testing.assert_allclose(got[rank]["steps"][case]["loss"],
                                   want["steps"][case]["loss"], rtol=0,
                                   atol=1e-4)
        _allclose_grads(got[rank]["steps"][case]["grads"],
                        want["steps"][case]["grads"])


def test_penalty_reads_the_global_batch_mean(steps):
    """In the penalty case the batch-mean ELBO is positive, and averaging
    each half's own penalty gradient (the penalty of each rank's mean) is
    outside the tolerance that the data-parallel step meets: the case
    tells the two apart."""
    _, want = steps
    w = want["steps"]["penalty"]
    assert w["elbo"] > 0
    naive = {k: (w["halves"][0][k] + w["halves"][1][k]) / 2
             for k in w["grads"]}
    far = [k for k in w["grads"] if not np.allclose(
        naive[k].numpy(), w["grads"][k].numpy(), rtol=2e-4, atol=2e-5)]
    assert far, "the local-penalty gradient is within the tolerance"


def test_data_init_sees_the_global_batch(steps):
    """The Trainer on a 2 x 1 mesh data-initialises ActNorm on the whole
    first batch on each rank: its ActNorm parameters are the single
    process's; then 3 steps with a finite best bpd and the parameters the
    same on both ranks; each rank's noise keyed on its rows."""
    got, _ = steps
    task = W.build_task("set")
    trainer = Trainer(task, W.train_config())
    first = next(task.train_batches(np.random.default_rng(
        trainer.config.seed)))
    trainer.init_model(first)
    want = W.actnorm_state(task.model)
    assert want
    for rank in (0, 1):
        (init,) = got[rank]["trainer"]["init"]
        np.testing.assert_array_equal(init["batch"]["x"], first["x"])
        for k, v in want.items():
            np.testing.assert_allclose(init["actnorm"][k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        assert np.isfinite(got[rank]["trainer"]["best_bpd"])
        assert got[rank]["trainer"]["step"] == 3
    for k, v in got[0]["trainer"]["state"].items():
        assert torch.equal(v, got[1]["trainer"]["state"][k]), k
    assert [got[r]["step_key"] for r in (0, 1)] == [(0,), (1,)]
    assert got[0]["mesh"] == ({"data": 2, "sample": 1}, 0,
                              {"data": 1, "sample": 2}, 0)
    assert got[1]["mesh"][1::2] == (1, 1)


def test_trainer_steps_per_call_on_a_data_mesh(steps):
    """6 steps at 2 a call on a 2 x 1 mesh: the final step is 6 and the
    best bpd finite on both ranks, and equal."""
    got, _ = steps
    for rank in (0, 1):
        assert got[rank]["trainer_k2"]["step"] == 6
        assert np.isfinite(got[rank]["trainer_k2"]["best_bpd"])
    assert got[0]["trainer_k2"]["best_bpd"] == got[1]["trainer_k2"][
        "best_bpd"]


def test_a_stop_on_one_rank_stops_every_rank(steps):
    """SIGTERM's stop flag raised on rank 1 alone after the first of 3 steps:
    both ranks leave the loop after that step and run the final phase as
    preempted, rather than one waiting on the other's collectives."""
    got, _ = steps
    for rank in (0, 1):
        assert got[rank]["stopped"] == {"step": 1, "preempted": 1.0}


@pytest.mark.parametrize("name", ["set", "molecules"])
def test_sharded_eval_matches_eval_step(name, steps):
    """The IS bpd with its 4 chains split over a 1 x 2 mesh equals
    ``eval_step`` on the same per-chain noise, on both ranks (the node-count
    prior of the molecule task included)."""
    got, want = steps
    for rank in (0, 1):
        np.testing.assert_allclose(got[rank]["eval"][name].numpy(),
                                   want["eval"][name].numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_effective_num_samples_tiles_the_sample_axis(steps):
    """3 chains on a sample axis of 2 evaluate 4, and ``test()`` logs 4."""
    got, _ = steps
    for rank in (0, 1):
        assert got[rank]["effective_3"] == 4
        assert got[rank]["test"]["num_importance_samples"] == 4
        assert np.isfinite(got[rank]["test"]["test_bpd"])


def test_one_rank_mesh_is_bitwise_no_mesh(worlds):
    """On a world of one rank the Trainer with ``create_mesh()`` logs every
    loss, gradient norm and eval bpd, and ends at every parameter, bitwise
    as the Trainer without a mesh (the all-reduces run all the same)."""
    (got,) = worlds[0]["one"].results()
    assert got["mesh"]["rows"] == got["none"]["rows"]
    assert [r["prefix"] for r in got["mesh"]["rows"]].count("train") == 4
    for k, v in got["none"]["state"].items():
        assert torch.equal(got["mesh"]["state"][k], v), k


def test_cli_builds_the_world_from_cnf_variables(worlds):
    """The set-shuffling CLI started on two ranks with the reference's
    ``CNF_COORDINATOR_ADDRESS``, ``CNF_NUM_PROCESSES`` and
    ``CNF_PROCESS_ID``: ``maybe_init_distributed`` joins a gloo world of 2
    at those ranks, both train data-parallel to the same finite best, only
    rank 0 writes the run, and the CLI leaves the world it joined."""
    got = worlds[0]["cli"].results()
    out = worlds[2]
    for rank in (0, 1):
        assert (got[rank]["world"], got[rank]["rank"],
                got[rank]["backend"]) == (2, rank, "gloo")
        assert np.isfinite(got[rank]["final"]["best_bpd"])
        assert got[rank]["left"]
    assert got[0]["final"]["best_bpd"] == got[1]["final"]["best_bpd"]
    rows = (out / "metrics.jsonl").read_text().splitlines()
    assert sum('"prefix": "train"' in r for r in rows) == 2
    assert (out / "config.json").exists()


def test_shard_batch_takes_contiguous_rows():
    """A rank's contiguous rows of a batch with a dict ``cond`` (the
    coloring's), on axis 0, and of a ``[K, B, ...]`` stack on axis 1; a
    batch that does not split evenly is refused."""
    r = np.random.default_rng(0)
    batch = {"x": r.integers(0, 3, (8, 5)), "mask": np.ones((8, 5)),
             "cond": {"adj": r.random((8, 5, 5))}}
    for rank in range(4):
        mesh = Mesh(4, 1, rank, None, None, None)
        part = shard_batch(mesh, batch)
        rows = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(part["x"], batch["x"][rows])
        np.testing.assert_array_equal(part["cond"]["adj"],
                                      batch["cond"]["adj"][rows])
        stack = shard_batch(mesh, {"x": np.stack([batch["x"]] * 3)}, axis=1)
        assert stack["x"].shape == (3, 2, 5)
        np.testing.assert_array_equal(stack["x"][2], batch["x"][rows])
    # the sample coordinate does not move the rows
    assert shard_batch(Mesh(2, 2, 3, None, None, None),
                       batch)["x"].tolist() == batch["x"][4:].tolist()
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(Mesh(3, 1, 0, None, None, None), batch)


def _jax_params(model, seed):
    """Seeded random weights of the reference's tree, shaped by tracing its
    ``init`` (none is run; as ``tests/test_torch_molecules.py``): the 1x1
    layers' permutations the identity and their signs 1, every other leaf
    N(0, 0.25^2), so that no coupling is the identity."""
    r = np.random.default_rng(seed)

    def leaf(path, shape):
        name, shp = getattr(path[-1], "key", ""), shape.shape
        if name in ("perm", "lower"):
            eye = np.broadcast_to(np.eye(shp[-1], dtype=np.float32), shp)
        if name == "perm":
            return eye.copy()
        if name == "sign_s":
            return np.ones(shp, np.float32)
        v = 0.25 * r.standard_normal(shp)
        if name == "lower":
            return (eye + np.tril(v, -1)).astype(np.float32)
        if name == "upper":
            return np.triu(v, 1).astype(np.float32)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(model.init, jax.random.PRNGKey(0)))


def test_elbo_hooks_match_reference_set_task(monkeypatch):
    """The set task's ``elbo``, ``num_vars`` and ``eval_bpd_extra`` against
    the reference's hooks on converted parameters and the same uniforms."""
    args = dict(W.TASKS["set"][2])
    jtask = jsm.SetShufflingTask(**args)
    ttask = W.build_task("set")
    params = _jax_params(jtask.model, 0)
    ttask.model.load_state_dict(from_jax_params(ttask, params))
    batch = jtask.eval_batches()[0]
    u = np.random.default_rng(4).uniform(
        1e-6, 1 - 1e-6, batch["x"].shape + (args["encoding_dim"],)
    ).astype(np.float32)

    def sample(rng, shape, mean=0.0, log_scale=0.0):
        logit_u = jnp.log(u) - jnp.log1p(-u)
        return jnp.float32(mean) + jnp.exp(jnp.float32(log_scale)) * logit_u
    monkeypatch.setattr(jnm, "logistic_sample", sample)
    jb = {"x": jnp.asarray(batch["x"])}
    want = np.asarray(jax.jit(jtask.elbo)(params, jb, jax.random.PRNGKey(1)))
    got = ttask.elbo(batch, noise=torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ttask.num_vars(batch).numpy(),
                                  np.asarray(jtask.num_vars(jb)))
    assert ttask.eval_bpd_extra(batch) == jtask.eval_bpd_extra(jb) == 0.0


def test_elbo_hooks_match_reference_molecule_task():
    """The molecule task's hooks against the reference's: the ELBO with the
    three stages' uniforms shared, the variable count (nodes and node
    pairs) and the node-count prior's share of the bits."""
    args = {k: v for k, v in W.TASKS["molecules"][2].items()}
    jtask = jmol.MoleculeTask(**args)
    ttask = W.build_task("molecules")
    params = _jax_params(jtask.model, 0)
    ttask.model.load_state_dict(from_jax_params(ttask, params))
    batch = jtask.eval_batches()[0]
    jb = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(3)
    m = ttask.model
    b, n = batch["atoms"].shape
    e = batch["edges"].shape[1]
    shapes = [(b, n, m.enc_node.dim), (b, e, m.enc_exist.dim),
              (b, e, m.enc_bond.dim)]
    noise = tuple(torch.from_numpy(np.array(jax.random.uniform(
        k, s, jnp.float32, minval=1e-6, maxval=1.0 - 1e-6)))
        for k, s in zip(jax.random.split(key, 3), shapes))
    want = np.asarray(jax.jit(jtask.elbo)(params, jb, key))
    got = ttask.elbo(batch, noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ttask.num_vars(batch).numpy(),
                               np.asarray(jtask.num_vars(jb)), rtol=0)
    np.testing.assert_allclose(ttask.eval_bpd_extra(batch).numpy(),
                               np.asarray(jtask.eval_bpd_extra(jb)),
                               rtol=1e-6)
