"""``steps_per_call = K`` in the port's Trainer, on the CPU.

The reference runs K steps a call as a ``lax.scan`` over a [K, B, ...]
stack of batches (``categoricalnf_tpu/training/engine.py:257-331``); the
port runs them as an eager loop.  These tests hold the port to what the
reference's loop does: the training batches come in groups of K from the
seed's stream (the first group's first batch data-initialises the model),
the steps and their noise are those of single steps on the same batches,
a remainder that does not fill a group runs as single steps on batches of
a stream seeded ``seed + 17``, and the logging, eval and checkpoint
cadences fire where a call crosses them.  The parameters are compared
exactly: both sides run the same CPU arithmetic.
"""

import json
import os

import numpy as np
import pytest
import torch

from categoricalnf_tpu_torch.tasks import SetShufflingTask
from categoricalnf_tpu_torch.training.checkpoint import CheckpointManager
from categoricalnf_tpu_torch.training.engine import (TrainConfig, Trainer,
                                                     grouped,
                                                     step_generator)
from categoricalnf_tpu_torch.training.schedules import ScheduleSpec
from categoricalnf_tpu_torch.training.state import (OptimizerConfig,
                                                    TrainState)

# one intra-op thread: pytest-xdist runs six workers at once, and each at
# torch's default pool oversubscribes the cores on these small tensors
torch.set_num_threads(1)

SEED = 3
TINY = dict(set_size=8, batch_size=16, num_layers=2, hidden_dim=16,
            num_mixtures=3, encoding_dim=2, eval_batches_count=1,
            compute_dtype="float32", device="cpu")


def _cfg(out_dir, num_steps, k, **kw):
    return TrainConfig(num_steps=num_steps, eval_every=5, eval_samples=2,
                       final_eval_samples=2, log_every=3, out_dir=out_dir,
                       seed=SEED, steps_per_call=k,
                       optimizer=OptimizerConfig(learning_rate=3e-3),
                       beta_schedule=ScheduleSpec(kind="sigmoid", start=0.5,
                                                  end=1.0, center=4,
                                                  rate=0.5), **kw)


def _replay(batches, calib, cfg):
    """Single steps, written out, on ``batches`` from the model the trainer
    starts from (the seed's, data-initialised on ``calib``)."""
    task = SetShufflingTask(**TINY)
    task.init_params(cfg.seed)
    task.data_init(calib, generator=step_generator(task.device, cfg.seed,
                                                   999))
    state = TrainState.create(task.model, cfg.optimizer)
    beta = cfg.beta_schedule.build()
    for step, batch in enumerate(batches):
        loss = task.loss(batch, beta(step), generator=step_generator(
            task.device, cfg.seed, step))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
    return task.model.state_dict()


@pytest.mark.parametrize("k,num_steps", [(4, 10), (3, 9), (4, 3)])
def test_k_steps_a_call_are_single_steps_on_the_same_batches(tmp_path, k,
                                                             num_steps):
    """The last parameters of a run at K steps a call equal single steps
    on the grouped stream's batches after the calibration group, then the
    remainder's batches from the ``seed + 17`` stream."""
    out = str(tmp_path / "run")
    cfg = _cfg(out, num_steps, k)
    task = SetShufflingTask(**TINY)
    Trainer(task, cfg).train(resume=False)
    last = CheckpointManager(out, keep=1, subdir="checkpoints_last")
    assert last.latest_step() == num_steps
    got = last.restore_latest()["model"]

    main = SetShufflingTask(**TINY).train_batches(
        np.random.default_rng(SEED))
    calib = next(main)
    for _ in range(k - 1):  # the rest of the calibration group
        next(main)
    full = (num_steps // k) * k
    rest = SetShufflingTask(**TINY).train_batches(
        np.random.default_rng(SEED + 17))
    batches = ([next(main) for _ in range(full)]
               + [next(rest) for _ in range(num_steps - full)])
    want = _replay(batches, calib, cfg)
    assert set(got) == set(want)
    for name, v in want.items():
        assert torch.equal(got[name], v), name


def test_cadences_fire_on_crossings(tmp_path):
    """K = 4 over 10 steps: calls end at 4 and 8, the remainder at 9 and
    10.  log_every 3 fires at 4 (crossing 3), 8 (6) and 9 (9); eval_every
    5 at 8 (crossing 5) and 10 (10, the end), each eval with its "last"
    checkpoint.  ``steps_per_s`` counts the steps since the last window."""
    out = str(tmp_path / "run")
    Trainer(SetShufflingTask(**TINY), _cfg(out, 10, 4)).train(resume=False)
    rows = [json.loads(line)
            for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows if r["prefix"] == "train"] == [4, 8, 9]
    assert [r["step"] for r in rows if r["prefix"] == "val"] == [8, 10]
    assert all(np.isfinite(r["loss"]) and r["steps_per_s"] > 0
               for r in rows if r["prefix"] == "train")
    assert [r["prefix"] for r in rows[-2:]] == ["test", "final"]
    assert os.listdir(os.path.join(out, "checkpoints_last")) == [
        "step_00000010.pt"]


def test_single_step_runs_keep_their_stream(tmp_path):
    """K = 1 takes its steps from the seed's stream right after the
    calibration batch, as before; K = 1 and K > 1 so differ from step 0."""
    cfg = _cfg(None, 4, 1)
    trainer = Trainer(SetShufflingTask(**TINY), cfg)
    trainer.train(resume=False)
    main = SetShufflingTask(**TINY).train_batches(
        np.random.default_rng(SEED))
    calib = next(main)
    want = _replay([next(main) for _ in range(4)], calib, cfg)
    got = trainer.state.model.state_dict()
    # the final phase loaded the best evaluation's parameters: step 4's
    assert all(torch.equal(got[n], v) for n, v in want.items())


def test_grouped_and_refused():
    it = iter(range(10))
    g = grouped(it, 3)
    assert next(g) == [0, 1, 2] and next(g) == [3, 4, 5]
    with pytest.raises(ValueError, match="steps_per_call"):
        Trainer(SetShufflingTask(**TINY), _cfg(None, 4, 0))
