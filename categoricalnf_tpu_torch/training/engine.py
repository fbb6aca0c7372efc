"""Training engine: the host loop around one eager train step.

Counterpart of ``categoricalnf_tpu/training/engine.py``: the loop, beta
from its schedule, gradient clipping and RAdam, periodic importance-sampled
evaluation in fp32 with the integrity alarm, best-metric checkpoints (an
alarmed eval never becomes best) beside periodic "last" ones, resume from
the newer of the two with the best re-evaluated, SIGTERM handling, and the
final phase (sample metrics of the best parameters, then ``test``).

``steps_per_call = K > 1`` takes the training batches in groups of K, as
the reference's ``[K, B, ...]`` stacks (the first group's first batch
data-initialises the model), runs each group's K steps in one call of an
eager loop, and fires the logging, eval and checkpoint cadences where a
call crosses them; a remainder that does not fill a group (at the end, or
after a resume off a multiple of K) runs as single steps on batches of a
stream of its own, seeded ``seed + 17``.  The steps and their noise are
those of K = 1 on the same batches.

With a ``mesh`` (``parallel/mesh.py``, one process a rank), every rank
draws the same seeded stream of global batches and trains on its rows of
each: ActNorm's data init runs on the whole first batch on every rank, the
positive-ELBO penalty reads the global batch's mean, the gradients are
averaged over the world before the clip, and the IS evals split their
chains and rows over the mesh (``parallel/eval.py``); only rank 0 writes
metrics, checkpoints and samples.  A 1 x 1 mesh trains bitwise as no mesh.

Differences from the reference: the step runs eagerly (no jit or
profiler); the per-step noise comes from a ``torch.Generator`` seeded from
``(seed, step)``, and from ``(seed, step, data coordinate)`` on a mesh of
several data ranks, so a resume reproduces the stream; ``steps_per_s``
counts training steps only (the clock restarts after an eval or a save).
"""

from __future__ import annotations

import dataclasses
import math
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from categoricalnf_tpu_torch.data.prefetch import Prefetcher, pin, to_device
from categoricalnf_tpu_torch.parallel.eval import make_task_sharded_iw_eval
from categoricalnf_tpu_torch.parallel.mesh import Mesh, shard_batch
from categoricalnf_tpu_torch.training.checkpoint import CheckpointManager
from categoricalnf_tpu_torch.training.metrics import MetricsLogger
from categoricalnf_tpu_torch.training.schedules import ScheduleSpec
from categoricalnf_tpu_torch.training.state import (OptimizerConfig,
                                                    TrainState)
from categoricalnf_tpu_torch.training.task import TaskTemplate

# streams of the step generators beside the training steps' own: data
# init, evaluations (offset by the step), final samples and the samples
# written to the run directory, the test split
_DATA_INIT, _EVAL, _FINAL_SAMPLES, _ARTIFACTS, _TEST = (999, 2**30, 777, 778,
                                                       2**31)
# the seed offset of the remainder's batch stream when steps_per_call > 1
_REMAINDER_STREAM = 17


def step_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the ints ``key``, such as
    ``(seed, step)``."""
    s = np.random.SeedSequence([int(k) for k in key])
    return torch.Generator(device).manual_seed(
        int(s.generate_state(1, np.uint64)[0] >> 1))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 10_000
    eval_every: int = 1_000
    eval_samples: int = 8
    final_eval_samples: int = 32
    seed: int = 42
    optimizer: OptimizerConfig = OptimizerConfig()
    beta_schedule: ScheduleSpec = ScheduleSpec(
        kind="sigmoid", start=0.5, end=1.0, center=2000, rate=0.002)
    out_dir: Optional[str] = None
    log_every: int = 100
    steps_per_call: int = 1


def grouped(batches, k: int):
    """Lists of ``k`` consecutive batches of ``batches``."""
    while True:
        yield [next(batches) for _ in range(k)]


class Trainer:
    def __init__(self, task: TaskTemplate, config: TrainConfig,
                 mesh: Optional[Mesh] = None):
        if config.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be at least 1, got "
                             f"{config.steps_per_call}")
        self.task = task
        self.config = config
        self.mesh = mesh
        # rank 0 writes the run's files and prints its metrics
        self.writes = mesh is None or mesh.rank == 0
        self.beta_fn = config.beta_schedule.build()
        self.logger = MetricsLogger(config.out_dir if self.writes else None,
                                    echo=self.writes)
        self.state: Optional[TrainState] = None
        self._sharded_eval = (None if mesh is None
                              else make_task_sharded_iw_eval(task, mesh))
        # what keys a rank's noise beside the step: its rows' coordinate
        # (its chains' too for an eval), none where the mesh has one rank
        self._step_key = (() if mesh is None or mesh.num_data == 1
                          else (mesh.data_index,))
        self._eval_key = (() if mesh is None or mesh.world == 1
                          else (mesh.data_index, mesh.sample_index))

    def _rows(self, batch):
        """This rank's rows of a global batch (all of it without a mesh)."""
        return batch if self.mesh is None else shard_batch(self.mesh, batch)

    def init_model(self, batch: dict) -> None:
        """Fresh parameters from the seed, ActNorm data-initialised on
        ``batch``: with the first training batch, the model that ``train``
        starts from when there is no checkpoint.  On a mesh every rank
        runs it on the whole global batch with the same generator, so that
        ActNorm takes the global batch's statistics."""
        self.task.init_params(self.config.seed)
        self.task.data_init(batch, generator=step_generator(
            self.task.device, self.config.seed, _DATA_INIT))

    # -- evaluation -------------------------------------------------------

    def _eval_batches(self, batches, num_samples: int, *stream: int):
        bpds = []
        for i, batch in enumerate(batches):
            gen = step_generator(self.task.device, self.config.seed, *stream,
                                 i, *self._eval_key)
            fn = self._sharded_eval or self.task.eval_step
            bpds.append(fn(batch, num_samples, generator=gen).cpu().numpy())
        return float(np.mean(np.concatenate(bpds)))

    def evaluate(self, num_samples: int, seed_step: int) -> dict:
        """fp32 importance-sampled bits/var of the eval batches; the alarm is
        raised by a bpd below the analytic optimum (by 0.1) or below 0,
        both impossible for a normalised model."""
        bpd = self._eval_batches(self.task.eval_batches(), num_samples,
                                 seed_step)
        out = {"bpd": bpd, "integrity_alarm": 0.0}
        opt = self.task.analytic_optimum_bpd()
        if opt is not None:
            out["bpd_gap_to_optimum"] = bpd - opt
            if bpd < opt - 0.1:
                out["integrity_alarm"] = 1.0
                print(f"WARNING: eval bpd {bpd:.3f} below analytic optimum "
                      f"{opt:.3f}: numerically invalid model, investigate",
                      flush=True)
        if bpd < 0:
            out["integrity_alarm"] = 1.0
            print(f"WARNING: negative eval bpd {bpd:.3f}: numerically "
                  "invalid model, investigate", flush=True)
        return out

    def test(self, num_samples: Optional[int] = None, seed: int = 7) -> dict:
        """Test-split evaluation with the final IS-sample count."""
        num_samples = num_samples or self.config.final_eval_samples
        bpd = self._eval_batches(self.task.test_batches(), num_samples,
                                 _TEST, seed)
        if self._sharded_eval is not None:
            # the chain count rounded up to tile the sample axis
            num_samples = self._sharded_eval.effective_num_samples(
                num_samples)
        out = {"test_bpd": bpd, "num_importance_samples": num_samples}
        opt = self.task.analytic_optimum_bpd()
        if opt is not None:
            out["test_gap_to_optimum"] = bpd - opt
        return out

    # -- loop -------------------------------------------------------------

    def train(self, resume: bool = True) -> dict:
        cfg, task = self.config, self.task
        batches = task.train_batches(np.random.default_rng(cfg.seed))
        if cfg.steps_per_call > 1:
            batches = grouped(batches, cfg.steps_per_call)
        data_iter = Prefetcher(
            batches, transform=pin if task.device.type == "cuda" else None)
        ckpt = ckpt_last = None
        if cfg.out_dir:
            ckpt = CheckpointManager(cfg.out_dir)
            ckpt_last = CheckpointManager(cfg.out_dir, keep=1,
                                          subdir="checkpoints_last")
        restore_src = None
        if resume and ckpt is not None:
            cands = [c for c in (ckpt, ckpt_last)
                     if c.latest_step() is not None]
            if cands:
                restore_src = max(cands, key=lambda c: c.latest_step())
        if restore_src is None:
            calib = next(data_iter)
            self.init_model(calib[0] if cfg.steps_per_call > 1 else calib)
        else:
            task.init_params(cfg.seed)
        self.state = state = TrainState.create(task.model, cfg.optimizer)
        best_bpd = math.inf
        if restore_src is not None:
            state.load_state_dict(restore_src.restore_latest())
            # re-evaluate the best checkpoint under the current eval rather
            # than trust its saved metrics; a stale low number would block
            # every later best
            best = ckpt.restore_latest()
            if best is not None:
                current = {k: v.clone() for k, v in
                           task.model.state_dict().items()}
                task.model.load_state_dict(best["model"])
                best_bpd = self.evaluate(cfg.eval_samples,
                                         _EVAL - 1)["bpd"]
                task.model.load_state_dict(current)
            if self.writes:
                print(f"resumed from step {state.step} (best_bpd "
                      f"{best_bpd:.4f}, re-evaluated)", flush=True)

        self._stop_requested = False
        prev_handler = None
        if threading.current_thread() is threading.main_thread():
            def _on_sigterm(signum, frame):
                self._stop_requested = True
                print("SIGTERM: finishing current step, then final eval",
                      flush=True)
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        try:
            return self._train_loop(data_iter, state, ckpt, ckpt_last,
                                    best_bpd)
        finally:
            # kept through the whole final phase: a second SIGTERM must not
            # kill the run mid-save
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            data_iter.close()
            self.logger.close()

    def gradients(self, batch, beta, *, generator=None, noise=None):
        """The loss of ``batch`` (this rank's rows, on the task's device) at
        ``beta``, its gradients left in the parameters' ``.grad``; on a mesh
        the global batch's loss, with the gradients averaged over the
        world."""
        task, mesh = self.task, self.mesh
        loss = task.loss(batch, beta, generator=generator, noise=noise,
                         batch_mean=None if mesh is None else mesh.batch_mean)
        task.model.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            mesh.average_gradients(task.model.parameters())
            loss = mesh.data_mean(loss.detach())
        return loss

    def _step(self, state, batch):
        """One train step on ``batch``: ``gradients`` at beta of the step,
        then the clipped update.  Returns (loss, gradient norm, beta)."""
        beta = self.beta_fn(state.step)
        loss = self.gradients(batch, beta, generator=step_generator(
            self.task.device, self.config.seed, state.step, *self._step_key))
        return loss, state.apply_gradients(), beta

    def _stopping(self) -> bool:
        """SIGTERM's stop, agreed over the mesh: every rank leaves the loop
        at the same step."""
        if self.mesh is not None:
            self._stop_requested = self.mesh.any(self._stop_requested)
        return self._stop_requested

    def _train_loop(self, data_iter, state, ckpt, ckpt_last,
                    best_bpd) -> dict:
        cfg, task = self.config, self.task
        model = task.model
        per_call = cfg.steps_per_call
        # the remainder's batches: a fresh stream, the grouped one is the
        # prefetcher's
        single = (task.train_batches(np.random.default_rng(
            cfg.seed + _REMAINDER_STREAM)) if per_call > 1 else data_iter)
        best_state = None
        t_last, steps_since = time.perf_counter(), 0
        while state.step < cfg.num_steps and not self._stopping():
            prev = state.step
            if per_call > 1 and prev + per_call <= cfg.num_steps:
                group = [to_device(self._rows(b), task.device)
                         for b in next(data_iter)]
            else:
                group = [to_device(self._rows(next(single)), task.device)]
            for batch in group:
                loss, gnorm, beta = self._step(state, batch)
            step = state.step
            steps_since += step - prev

            def crossed(every):  # a cadence boundary inside (prev, step]
                return step // every > prev // every

            if crossed(cfg.log_every):
                # reading the loss waits for the step: the rate is wall time
                m = {"loss": float(loss.detach()),
                     "grad_norm": float(gnorm) if gnorm is not None else 0.0,
                     "beta": beta}
                dt = time.perf_counter() - t_last
                m["steps_per_s"] = steps_since / max(dt, 1e-9)
                self.logger.log(step, m, "train")
                t_last, steps_since = time.perf_counter(), 0

            if crossed(cfg.eval_every) or step == cfg.num_steps:
                is_final = step == cfg.num_steps
                ev = self.evaluate(cfg.final_eval_samples if is_final
                                   else cfg.eval_samples, _EVAL + step - 1)
                self.logger.log(step, ev, "val")
                if ev["bpd"] < best_bpd and not ev["integrity_alarm"]:
                    best_bpd = ev["bpd"]
                    best_state = {k: v.detach().clone() for k, v in
                                  model.state_dict().items()}
                    if ckpt is not None and self.writes:
                        ckpt.save(step, model, optimizer=state.optimizer,
                                  metrics=ev)
                # the periodic "last" checkpoint beside the best-metric one
                if ckpt_last is not None and self.writes:
                    ckpt_last.save(step, model, optimizer=state.optimizer)
                # the rate counts training steps only
                t_last, steps_since = time.perf_counter(), 0

        if self._stop_requested and ckpt_last is not None and self.writes:
            ckpt_last.save(state.step, model, optimizer=state.optimizer)

        # the final phase runs on the best parameters (what best_bpd refers
        # to), which the model keeps afterwards; the last ones are in
        # checkpoints_last
        if best_state is None and ckpt is not None and ckpt.latest_step():
            best_state = ckpt.restore_latest()["model"]
        if best_state is not None:
            model.load_state_dict(best_state)
        final = {"best_bpd": best_bpd}
        if self._stop_requested:
            final["preempted"] = 1.0
        final.update(task.sample_metrics(generator=step_generator(
            task.device, cfg.seed, _FINAL_SAMPLES)))
        if cfg.out_dir and self.writes:
            task.sample_artifacts(cfg.out_dir, generator=step_generator(
                task.device, cfg.seed, _ARTIFACTS))
        test_metrics = self.test()
        final.update(test_metrics)
        self.logger.log(state.step, test_metrics, "test")
        self.logger.log(state.step, final, "final")
        return final
