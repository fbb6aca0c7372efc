"""Worker functions of ``tests/test_torch_parallel.py``: each runs in a
process of its own (the spawn start method), one a rank of a world over
gloo on the CPU.  Imports no JAX, so that a child starts with torch and the
port alone.

``run`` joins the world (a ``FileStore``, or the ``CNF_*`` variables that
the experiment CLIs read), calls one of the worlds below on the inputs the
parent saved, writes what it returns to ``<out>/<rank>.pt`` (or the
traceback to ``<out>/<rank>.err``) and leaves the world.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

TASKS = {
    "set": ("categoricalnf_tpu_torch.tasks.set_modeling", "SetShufflingTask",
            dict(set_size=6, batch_size=8, num_layers=2, hidden_dim=16,
                 num_mixtures=3, encoding_dim=2, eval_batches_count=1,
                 compute_dtype="float32")),
    "molecules": ("categoricalnf_tpu_torch.tasks.molecules", "MoleculeTask",
                  dict(dataset="synthetic", max_nodes=9, batch_size=8,
                       num_layers_node=2, num_layers_edge=2, hidden_dim=16,
                       num_mixtures=3, synth_size=32, node_cond_atoms=True,
                       bond_cond_degree=True, eval_batches_count=1,
                       metric_samples=8, compute_dtype="float32")),
    "lm_hmm": ("categoricalnf_tpu_torch.tasks.language",
               "LanguageModelingTask",
               dict(corpus_name="synthetic", seq_len=12, batch_size=8,
                    encoding_dim=2, num_layers=1, hidden_dim=16,
                    lstm_layers=1, num_mixtures=2, prior="hmm",
                    prior_states=4, eval_batches_count=1,
                    compute_dtype="float32")),
}
# added to every per-example ELBO of the "penalty" case: the batch-mean
# ELBO is then positive, so the positive-ELBO penalty is active
ELBO_OFFSET = 40.0


def build_task(name: str, **kw):
    """A tiny port task on the CPU: ``TASKS[name]``'s arguments, ``kw``
    over them."""
    import importlib
    module, cls, args = TASKS[name]
    return getattr(importlib.import_module(module), cls)(
        **{**args, **kw}, device="cpu")


def offset_elbo(task, offset: float = ELBO_OFFSET) -> None:
    """Shift the per-example ELBO that the loss's penalty reads by
    ``offset`` (the beta-annealed objective keeps its own terms)."""
    elbo = task.model.elbo

    def shifted(*a, **kw):
        parts = dict(elbo(*a, **kw))
        parts["elbo"] = parts["elbo"] + offset
        return parts
    task.model.elbo = shifted


def noise_for(task, batch: dict, rng: np.random.Generator, lead=()):
    """Uniforms of the task's encoders for ``batch`` (a tuple of the three
    stages' for GraphCNF), with the leading axes ``lead``."""
    def u(*shape):
        return torch.from_numpy(rng.uniform(1e-6, 1 - 1e-6, lead + shape)
                                .astype(np.float32))
    model = task.model
    if hasattr(model, "enc_node"):
        b, n = batch["atoms"].shape
        e = batch["edges"].shape[1]
        return (u(b, n, model.enc_node.dim), u(b, e, model.enc_exist.dim),
                u(b, e, model.enc_bond.dim))
    b, t = batch["x"].shape
    return u(b, t, model.encoding.dim)


def grads(model) -> dict:
    return {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}


def actnorm_state(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith((".bias", ".log_scale")) and "layers" in k}


def train_config(**kw):
    from categoricalnf_tpu_torch.training.engine import TrainConfig
    args = dict(num_steps=3, eval_every=3, eval_samples=2,
                final_eval_samples=2, log_every=1, seed=3)
    return TrainConfig(**{**args, **kw})


def spy_init(trainer) -> list:
    """Record the batch ``Trainer.init_model`` is given and the ActNorm
    parameters it leaves."""
    seen = []
    init = trainer.init_model

    def spy(batch):
        init(batch)
        seen.append({"batch": batch,
                     "actnorm": actnorm_state(trainer.task.model)})
    trainer.init_model = spy
    return seen


def steps_world(rank: int, inputs: dict) -> dict:
    """Two ranks: one data-parallel step of each case on a 2 x 1 mesh; the
    Trainer there (data init, 3 steps; 6 at 2 steps a call); the sharded
    eval on a 1 x 2 mesh and the Trainer's test there."""
    from categoricalnf_tpu_torch.parallel import (create_mesh,
                                                  make_task_sharded_iw_eval,
                                                  shard_batch)
    from categoricalnf_tpu_torch.training.engine import Trainer
    data_mesh = create_mesh()
    sample_mesh = create_mesh(num_data=1, num_sample=2)
    out = {"mesh": (data_mesh.shape, data_mesh.data_index,
                    sample_mesh.shape, sample_mesh.sample_index),
           "steps": {}, "step_key": None}
    for case, spec in inputs["steps"].items():
        task = build_task(spec["task"])
        task.model.load_state_dict(spec["state"])
        if case == "penalty":
            offset_elbo(task)
        trainer = Trainer(task, train_config(), mesh=data_mesh)
        loss = trainer.gradients(shard_batch(data_mesh, spec["batch"]), 0.8,
                                 noise=shard_batch(data_mesh, spec["noise"]))
        out["steps"][case] = {"loss": float(loss),
                              "grads": grads(task.model)}

    task = build_task("set")
    trainer = Trainer(task, train_config(), mesh=data_mesh)
    out["step_key"] = trainer._step_key
    seen = spy_init(trainer)
    final = trainer.train(resume=False)
    out["trainer"] = {"best_bpd": final["best_bpd"],
                      "step": trainer.state.step, "init": seen,
                      "state": task.model.state_dict()}
    trainer = Trainer(task, train_config(num_steps=6, eval_every=6,
                                         steps_per_call=2), mesh=data_mesh)
    final = trainer.train(resume=False)
    out["trainer_k2"] = {"best_bpd": final["best_bpd"],
                         "step": trainer.state.step}
    # a stop (SIGTERM's flag) raised on rank 1 alone after the first step
    trainer = Trainer(task, train_config(), mesh=data_mesh)
    step = trainer._step

    def step_then_stop(state, batch):
        result = step(state, batch)
        trainer._stop_requested = trainer._stop_requested or rank == 1
        return result
    trainer._step = step_then_stop
    final = trainer.train(resume=False)
    out["stopped"] = {"step": trainer.state.step,
                      "preempted": final.get("preempted")}

    out["eval"] = {}
    for name, spec in inputs["eval"].items():
        task = build_task(name)
        task.model.load_state_dict(spec["state"])
        fn = make_task_sharded_iw_eval(task, sample_mesh)
        out["eval"][name] = fn(spec["batch"], spec["chains"],
                               noise=spec["noise"])
    out["effective_3"] = fn.effective_num_samples(3)
    task = build_task("set")
    trainer = Trainer(task, train_config(), mesh=sample_mesh)
    trainer.init_model(next(task.train_batches(np.random.default_rng(0))))
    out["test"] = trainer.test(num_samples=3)
    return out


def one_rank_world(rank: int, inputs: dict) -> dict:
    """One rank: the Trainer on a 1 x 1 mesh and without one, from the same
    seed; every metrics row and the final parameters of each."""
    import json

    from categoricalnf_tpu_torch.parallel import create_mesh
    from categoricalnf_tpu_torch.training.engine import Trainer
    mesh = create_mesh()
    out = {}
    for arm in ("mesh", "none"):
        task = build_task("set")
        run = os.path.join(inputs["dir"], arm)
        trainer = Trainer(task, train_config(num_steps=4, eval_every=2,
                                             out_dir=run),
                          mesh=mesh if arm == "mesh" else None)
        trainer.train(resume=False)
        rows = [json.loads(line) for line in
                open(os.path.join(run, "metrics.jsonl"))]
        out[arm] = {"rows": [{k: v for k, v in r.items() if k != "time"
                              and k != "steps_per_s"} for r in rows],
                    "state": task.model.state_dict()}
    return out


def cli_world(rank: int, inputs: dict) -> dict:
    """The set-shuffling CLI as a launcher starts it on each rank: the
    world comes from the ``CNF_*`` variables alone, and the CLI leaves it
    at the end."""
    from categoricalnf_tpu_torch.experiments import set_shuffling
    from categoricalnf_tpu_torch.parallel import mesh
    seen = {}
    create_mesh = mesh.create_mesh

    def spy(*a, **kw):
        seen.update(world=dist.get_world_size(), rank=dist.get_rank(),
                    backend=dist.get_backend())
        return create_mesh(*a, **kw)
    import categoricalnf_tpu_torch.utils.cli as cli
    cli.create_mesh = spy
    final = set_shuffling.main(inputs["argv"])
    return {"final": final, "left": not dist.is_initialized(), **seen}


def run(rank: int, world: int, fn: str, inputs_path: str, out: str,
        store: str | None, env: dict) -> None:
    """A child's entry: join the world, run ``fn``, write its result."""
    torch.set_num_threads(1)
    try:
        os.environ.update(env)
        if store is not None:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store, world), rank=rank,
                world_size=world)
        inputs = torch.load(inputs_path, weights_only=False)
        result = globals()[fn](rank, inputs)
        torch.save(result, os.path.join(out, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

