#!/usr/bin/env python3
"""The data-parallel path on several cards against one process: run one
process a card with the launcher's variables, as the experiment CLIs are.

    for r in 0 1 2 3; do
      CNF_COORDINATOR_ADDRESS=localhost:29501 CNF_NUM_PROCESSES=4 \\
        CNF_PROCESS_ID=$r python3 tools/dp_check.py &
    done; wait

runs/set16's model in fp32 (the FMA pair on the card) at 1,024 sets a rank,
data-initialised and moved off its initial point: one step's loss and
gradients on the world's data mesh (the global noise sliced to each
rank's rows) against rank 0 alone on the whole batch, as a ratio of the
worst gradient's distance to the reference's tolerance (rtol 2e-4, atol
2e-5; tests/test_sharding.py), whether every rank ends with rank 0's
gradients, and, on an even world, the sharded IS eval on a (world/2) x 2
mesh against eval_step on the same per-chain noise.  Each rank prints one
JSON line.  ``--device cpu --tiny`` runs a tiny model over gloo on the CPU.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from categoricalnf_tpu_torch import inference  # noqa: E402
from categoricalnf_tpu_torch.parallel import (create_mesh,  # noqa: E402
                                              make_task_sharded_iw_eval,
                                              maybe_init_distributed,
                                              shard_batch)
from categoricalnf_tpu_torch.training.engine import (TrainConfig,  # noqa
                                                     Trainer)
from categoricalnf_tpu_torch.utils.config import load_config  # noqa: E402
from categoricalnf_tpu_torch.utils.tree import tree_map  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--tiny", action="store_true")
a = ap.parse_args()
device = maybe_init_distributed(a.device)
rank, world = dist.get_rank(), dist.get_world_size()
args = dict(load_config(os.path.join(REPO, "runs", "set16"))["args"])
args.update(compute_dtype="float32", seed=0, eval_batches_count=1,
            batch_size=1024 * world)
if a.tiny:
    args.update(batch_size=8 * world, set_size=6, num_layers=2,
                hidden_dim=16, num_mixtures=3, encoding_dim=2)
task = inference.build_task("set_shuffling", args, device=str(device))
batch = next(task.train_batches(np.random.default_rng(1)))
trainer = Trainer(task, TrainConfig(seed=0))
trainer.init_model(batch)
g = torch.Generator().manual_seed(5)
with torch.no_grad():
    for p in task.model.parameters():
        p.add_(0.02 * torch.randn(p.shape, generator=g).to(p.device))
state = {k: v.clone() for k, v in task.model.state_dict().items()}
n, t = batch["x"].shape
noise = torch.from_numpy(np.random.default_rng(2).uniform(
    1e-6, 1 - 1e-6, (n, t, task.model.encoding.dim)).astype(np.float32))

want = {}
if rank == 0:
    loss = trainer.gradients(batch, 0.8, noise=noise.to(device))
    want = {"loss": float(loss.detach()), "grads": {
        k: p.grad.clone() for k, p in task.model.named_parameters()
        if p.grad is not None}}
task.model.load_state_dict(state)
mesh = create_mesh()
dp = Trainer(task, TrainConfig(seed=0), mesh=mesh)
loss = dp.gradients(shard_batch(mesh, batch), 0.8,
                    noise=shard_batch(mesh, noise).to(device))
got = {k: p.grad.clone() for k, p in task.model.named_parameters()
       if p.grad is not None}
report = {"rank": rank, "world": world, "device": str(device),
          "backend": dist.get_backend(), "loss": float(loss)}
if rank == 0:
    worst = max(float(((got[k] - w).abs() / (2e-5 + 2e-4 * w.abs())).max())
                for k, w in want["grads"].items())
    report.update(want_loss=want["loss"],
                  loss_err=abs(float(loss) - want["loss"]),
                  grads_ratio_to_tol=worst,
                  same_keys=sorted(got) == sorted(want["grads"]))
# every rank's parameters the same after the averaged gradients
flat = torch.cat([v.reshape(-1) for v in got.values()])
ref = flat.clone()
dist.broadcast(ref, 0)
report["grads_equal_rank0"] = bool(torch.equal(flat, ref))

if world % 2 == 0:
    emesh = create_mesh(num_data=world // 2, num_sample=2)
    eb = task.eval_batches()[0]
    en = np.random.default_rng(3).uniform(
        1e-6, 1 - 1e-6, (4, n, t, task.model.encoding.dim)).astype(np.float32)
    enoise = torch.from_numpy(en).to(device)
    got_bpd = make_task_sharded_iw_eval(task, emesh)(eb, 4, noise=enoise)
    want_bpd = task.eval_step(eb, 4, noise=enoise)
    report["eval_max_err"] = float((got_bpd - want_bpd).abs().max())
    report["eval_bpd"] = float(got_bpd.mean())
print(json.dumps(report), flush=True)
dist.destroy_process_group()
