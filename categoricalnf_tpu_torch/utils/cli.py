"""Shared argparse front end of the port's experiment CLIs.

Counterpart of ``categoricalnf_tpu/utils/cli.py``: the same flags, the same
``TrainConfig`` built from them, the same refusal of a ``--resume`` that
changes the architecture, and ``run_training``, which writes the run's
``config.json`` as ``{"args", "task"}`` so that ``inference.load_run`` and
``serve.py`` can rebuild the task.  ``--device`` picks the device (the card
unless ``cpu`` is given).  Started as one process a card with the
reference's ``CNF_COORDINATOR_ADDRESS``, ``CNF_NUM_PROCESSES`` and
``CNF_PROCESS_ID``, ``run_training`` joins their process group and trains
data-parallel over the mesh of all ranks, each on its own card.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch.distributed as dist

from categoricalnf_tpu_torch.inference import _ARG_RENAMES
from categoricalnf_tpu_torch.parallel.mesh import (create_mesh,
                                                   maybe_init_distributed)
from categoricalnf_tpu_torch.training.engine import TrainConfig, Trainer
from categoricalnf_tpu_torch.training.schedules import ScheduleSpec
from categoricalnf_tpu_torch.training.state import OptimizerConfig
from categoricalnf_tpu_torch.utils.config import (load_config, save_config,
                                                  set_seed)

# Architecture-defining CLI keys: resuming with another value would change
# the learned function, and some would not even fail a shape check.
_ARCH_KEYS = frozenset({
    "encoding", "encoding_dim", "num_layers", "hidden_dim", "num_mixtures",
    "compute_dtype", "lstm_layers", "net", "input_feats", "seq_len",
    "corpus", "dataset", "max_nodes", "num_layers_node", "num_layers_edge",
    "num_layers_bond",
    "edge_degree_norm", "bond_cond_exist", "node_cond_atoms",
    "bond_cond_degree", "set_size", "num_colors", "min_nodes", "edge_prob",
    "decoder", "vardeq_blocks", "vardeq_hidden", "vardeq_mixtures",
})


def default_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    g = p.add_argument_group("training")
    g.add_argument("--num_steps", type=int, default=10000)
    g.add_argument("--eval_every", type=int, default=1000)
    g.add_argument("--eval_samples", type=int, default=8)
    g.add_argument("--batch_size", type=int, default=1024)
    g.add_argument("--lr", type=float, default=7.5e-4)
    g.add_argument("--grad_clip", type=float, default=100.0)
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--out_dir", type=str, default=None)
    g.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in out_dir")
    g.add_argument("--log_every", type=int, default=100)
    g.add_argument("--beta_end", type=float, default=1.0)
    g.add_argument("--beta_warmup", type=int, default=2000)
    g.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps a call of the train loop; the "
                   "cadences fire where a call crosses them")
    g.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; raises without one)")
    m = p.add_argument_group("model")
    m.add_argument("--encoding", type=str, default="mixture",
                   choices=["mixture", "linear_flows", "vardeq"])
    m.add_argument("--encoding_dim", type=int, default=4)
    m.add_argument("--num_layers", type=int, default=8)
    m.add_argument("--hidden_dim", type=int, default=96)
    m.add_argument("--num_mixtures", type=int, default=8)
    # float64 runs only the plain path, as a reference: not a user option
    m.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    m.add_argument("--decoder", type=str, default="bayes",
                   choices=["bayes", "linear", "mlp"])
    m.add_argument("--vardeq_blocks", type=int, default=2)
    m.add_argument("--vardeq_hidden", type=int, default=64)
    m.add_argument("--vardeq_mixtures", type=int, default=4)
    return p


def train_config_from_args(args) -> TrainConfig:
    return TrainConfig(
        num_steps=args.num_steps,
        eval_every=args.eval_every,
        eval_samples=args.eval_samples,
        seed=args.seed,
        out_dir=args.out_dir,
        log_every=args.log_every,
        steps_per_call=getattr(args, "steps_per_call", 1),
        optimizer=OptimizerConfig(learning_rate=args.lr,
                                  grad_clip_norm=args.grad_clip),
        beta_schedule=ScheduleSpec(kind="sigmoid", start=0.5,
                                   end=args.beta_end,
                                   center=args.beta_warmup, rate=0.002),
    )


def check_resume_args(out_dir: str, args: dict, task=None) -> None:
    """Refuse a --resume whose architecture flags differ from the run's
    saved config (training knobs such as lr or num_steps may change).  A
    key missing from the saved config means the run trained with the
    task's default for it, so that default is compared."""
    cfg = load_config(out_dir)
    if cfg is None:
        return
    saved = cfg.get("args", {})
    defaults = {}
    if task is not None and dataclasses.is_dataclass(task):
        renames = {v: k for k, v in _ARG_RENAMES.items()}
        for f in dataclasses.fields(type(task)):
            if f.default is not dataclasses.MISSING:
                defaults[renames.get(f.name, f.name)] = f.default
    bad = {}
    for k in sorted(_ARCH_KEYS & set(args)):
        if k in saved:
            old = saved[k]
        elif k in defaults:
            old = defaults[k]
        else:
            continue
        if old != args[k]:
            bad[k] = (old, args[k])
    if bad:
        raise ValueError(
            f"--resume with changed architecture flags {bad} (saved vs "
            f"given): this would alter the learned function; start a fresh "
            f"out_dir instead")


def run_training(task, args) -> dict:
    set_seed(args.seed)
    cfg = train_config_from_args(args)
    joined = not dist.is_initialized()
    device = maybe_init_distributed(task.device)
    joined = joined and dist.is_initialized()
    if device is not None:
        # this rank's card: the Trainer rebuilds the model on it
        task.device = device
    mesh = create_mesh() if dist.is_initialized() else None
    try:
        if args.out_dir:
            if args.resume:
                check_resume_args(args.out_dir, vars(args), task=task)
            if mesh is None or mesh.rank == 0:
                save_config(args.out_dir, {"args": vars(args),
                                           "task": task.name})
        return Trainer(task, cfg, mesh=mesh).train(resume=args.resume)
    finally:
        if joined:  # the group this call joined, left with it
            dist.destroy_process_group()
