"""Set shuffling and set summation tasks (counterpart of
``categoricalnf_tpu/tasks/set_modeling.py``).

- Set shuffling: uniform over permutations of S distinct tokens; the
  analytic optimum log2(S!)/S bits/var is the correctness beacon.
- Set summation: uniform over sequences in {1..K}^S that sum to L; the
  optimum is log2(#{such sequences})/S from a counting DP.

Batches come from the port's copy of the reference's C++ generators
(``data/corpus.py``) where the host's compiler builds them, else from
numpy; either way the same seed gives the reference's batches.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Iterator, Optional

import numpy as np
import torch

from categoricalnf_tpu_torch import flows
from categoricalnf_tpu_torch.data import corpus as native
from categoricalnf_tpu_torch.encodings import create_encoding
from categoricalnf_tpu_torch.models.categorical_flow import CategoricalFlow
from categoricalnf_tpu_torch.networks import SetTransformer
from categoricalnf_tpu_torch.training.task import TaskTemplate
from categoricalnf_tpu_torch.utils.device import resolve_device

SAMPLE_CHUNK = 1024


def build_set_flow(dim: int, num_layers: int = 8, hidden_dim: int = 96,
                   num_heads: int = 4, num_mixtures: int = 8,
                   compute_dtype: str = "float32",
                   scan_blocks: Optional[bool] = None, remat: bool = False,
                   unroll: int = 1, *,
                   generator=None) -> flows.FlowModel:
    """Coupling stack: num_layers x [ActNorm, InvertibleLinear,
    MixtureCDFCoupling(SetTransformer), SoftClamp], parities alternating.

    ``scan_blocks=None`` resolves as the reference does: unrolled up to 8
    layers (the flagship), scanned above.  A scanned stack (an even
    ``num_layers`` of at least 4) is one ``ScannedBlocks`` of
    ``num_layers // 2`` two-parity blocks, which takes ``remat`` and
    ``unroll``; an unrolled one ignores both, as the reference's does.  The
    reference's ``fused`` has no counterpart: on the card every coupling
    net runs the fused kernel.
    """
    if scan_blocks is None:
        scan_blocks = num_layers > 8
    out_dim = dim * (2 + 3 * num_mixtures)
    return flows.coupling_stack(
        lambda: SetTransformer(dim, out_dim, hidden_dim=hidden_dim,
                               num_heads=num_heads, num_layers=2,
                               compute_dtype=compute_dtype,
                               generator=generator),
        dim, num_layers, num_mixtures, scan=scan_blocks, remat=remat,
        unroll=unroll, generator=generator)


def _encoding_kwargs(task) -> dict:
    """The encoding's extra arguments from the task's ablation knobs."""
    if task.encoding_name in ("vardeq", "variational_dequantization"):
        return {"num_blocks": task.vardeq_blocks,
                "hidden_dim": task.vardeq_hidden,
                "num_mixtures": task.vardeq_mixtures}
    if (task.encoding_name in ("mixture", "mixture_model")
            and task.decoder != "bayes"):
        return {"decoder": task.decoder}
    return {}


@dataclasses.dataclass
class _SetTask(TaskTemplate):
    """What the set tasks share: the encoding of ``num_cats`` categories,
    the coupling stack, and batches of ``_gen``.  The stack's remat,
    scan_blocks and unroll are constants here (class attributes, not
    fields); set shuffling makes them fields, as the reference does."""

    remat = False
    scan_blocks = None
    unroll = 1

    set_size: int = 16
    batch_size: int = 1024
    encoding_dim: int = 4
    encoding_name: str = "mixture"
    num_layers: int = 8
    hidden_dim: int = 96
    num_mixtures: int = 8
    eval_batches_count: int = 4
    compute_dtype: str = "float32"
    # the learned-decoder arm of a mixture encoding and the dequantization
    # flow's size (``_encoding_kwargs``); a saved ``fused`` is dropped by
    # ``build_task``, since the device picks the kernel
    decoder: str = "bayes"
    vardeq_blocks: int = 2
    vardeq_hidden: int = 64
    vardeq_mixtures: int = 4
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.init_params(self.seed)

    @property
    def num_cats(self) -> int:
        raise NotImplementedError

    def build_model(self, generator):
        enc = create_encoding(self.encoding_name, self.num_cats,
                              self.encoding_dim, generator=generator,
                              **_encoding_kwargs(self))
        flow = build_set_flow(enc.dim, self.num_layers, self.hidden_dim,
                              num_mixtures=self.num_mixtures,
                              compute_dtype=self.compute_dtype,
                              scan_blocks=self.scan_blocks, remat=self.remat,
                              unroll=self.unroll,
                              generator=generator)
        return CategoricalFlow(enc, flow)

    def _gen(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError

    def train_batches(self, rng: np.random.Generator) -> Iterator[dict]:
        while True:
            yield {"x": self._gen(rng, self.batch_size)}

    def eval_batches(self) -> list[dict]:
        rng = np.random.default_rng(1234)
        return [{"x": self._gen(rng, self.batch_size)}
                for _ in range(self.eval_batches_count)]


@dataclasses.dataclass
class SetShufflingTask(_SetTask):
    """Uniform over permutations of S tokens.  remat, scan_blocks and
    unroll act as the reference's (``build_set_flow``)."""

    remat: bool = False
    scan_blocks: Optional[bool] = None
    unroll: int = 1
    name: str = "set_shuffling"

    @property
    def num_cats(self) -> int:
        return self.set_size

    def _gen(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """The reference's draw: one ``integers(2**62)`` seeds the native
        generator; without it, numpy's argsort of uniforms after that
        draw."""
        out = native.gen_permutations(int(rng.integers(2**62)), n,
                                      self.set_size)
        if out is None:
            out = np.argsort(rng.random((n, self.set_size)), axis=1)
        return out.astype(np.int64)

    def analytic_optimum_bpd(self) -> float:
        return math.log2(math.factorial(self.set_size)) / self.set_size

    def sample_metrics(self, generator=None, num_samples: int | None = None,
                       temperature: float = 1.0) -> dict:
        """Fraction of sampled sequences that are exact permutations."""
        x = _sample_set(self.model, num_samples or SAMPLE_CHUNK,
                        self.set_size, temperature, generator)
        is_perm = (np.sort(x, axis=1)
                   == np.arange(self.set_size)[None, :]).all(axis=1)
        return {"permutation_validity": float(is_perm.mean()),
                "metric_num_samples": float(len(x))}


@torch.no_grad()
def _sample_set(model, num_samples: int, set_size: int, temperature: float,
                generator=None) -> np.ndarray:
    """Samples in chunks of up to 1024 sets; returns int [n, set_size]."""
    chunk = min(num_samples, SAMPLE_CHUNK)
    out, done = [], 0
    while done < num_samples:
        x = model.sample(chunk, set_size, temperature=float(temperature),
                         generator=generator)
        out.append(x.cpu().numpy())
        done += chunk
    return np.concatenate(out)[:num_samples]


@lru_cache(maxsize=None)
def _count_sum_sequences(length: int, num_cat: int, target: int) -> int:
    """The number of sequences in {1..K}^length that sum to ``target`` (a
    counting DP in Python ints)."""
    dp = [1] + [0] * target
    for _ in range(length):
        new = [0] * (target + 1)
        for s, n in enumerate(dp):
            if n:
                for v in range(1, min(num_cat, target - s) + 1):
                    new[s + v] += n
        dp = new
    return dp[target]


@dataclasses.dataclass
class SetSummationTask(_SetTask):
    """Uniform over {1..K}^S sequences that sum to L (0 means
    round(S (K + 1) / 2), the expected sum)."""

    num_categories: int = 10
    target_sum: int = 0
    name: str = "set_summation"

    def __post_init__(self):
        if self.target_sum == 0:
            self.target_sum = round(self.set_size
                                    * (self.num_categories + 1) / 2)
        super().__post_init__()

    @property
    def num_cats(self) -> int:
        return self.num_categories

    def _gen(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Rejection sampling, values shifted from 1..K to 0..K-1: the
        native generator seeded with one ``integers(2**62)``, as the
        reference's; without it, numpy after that draw, 4n candidates a
        round."""
        out = native.gen_sum_sequences(int(rng.integers(2**62)), n,
                                       self.set_size, self.num_categories,
                                       self.target_sum)
        if out is not None:
            return out.astype(np.int64)
        out = np.empty((0, self.set_size), np.int64)
        while out.shape[0] < n:
            cand = rng.integers(1, self.num_categories + 1,
                                (4 * n, self.set_size))
            ok = cand.sum(axis=1) == self.target_sum
            out = np.concatenate([out, cand[ok].astype(np.int64)])
        return out[:n] - 1

    def analytic_optimum_bpd(self) -> float:
        count = _count_sum_sequences(self.set_size, self.num_categories,
                                     self.target_sum)
        return math.log2(count) / self.set_size

    def sample_metrics(self, generator=None, num_samples: int | None = None,
                       temperature: float = 1.0) -> dict:
        """Fraction of sampled sequences that hit the target sum."""
        x = _sample_set(self.model, num_samples or SAMPLE_CHUNK,
                        self.set_size, temperature, generator)
        ok = (x + 1).sum(axis=1) == self.target_sum
        return {"sum_validity": float(ok.mean()),
                "metric_num_samples": float(len(x))}
