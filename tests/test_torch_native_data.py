"""The set tasks' native generators in the port against the JAX package's,
on the CPU.

The port's copy of ``gen_permutations`` and ``gen_sum_sequences``
(``categoricalnf_tpu_torch/data/corpus.cpp``) element for element against
the reference's ``native_loader``; both set tasks' training and eval
batches against the reference's, with both native libraries and with both
cached as None (the numpy paths); the seed-0 probe of 8 sets of 16 that
showed the shuffling task drawing other batches; ``CNF_NATIVE=0``.
"""

import shutil

import numpy as np
import pytest
import torch

from categoricalnf_tpu.data import native_loader
from categoricalnf_tpu.tasks import set_modeling as jsm
from categoricalnf_tpu_torch.data import corpus as tcorpus
from categoricalnf_tpu_torch.tasks import set_modeling as tsm

# one intra-op thread: pytest-xdist runs six workers at once
torch.set_num_threads(1)

TINY = dict(set_size=6, batch_size=8, num_layers=2, hidden_dim=16,
            num_mixtures=3, encoding_dim=2, eval_batches_count=1,
            compute_dtype="float32")
TASKS = {"shuffling": (jsm.SetShufflingTask, tsm.SetShufflingTask, {}),
         "summation": (jsm.SetSummationTask, tsm.SetSummationTask,
                       {"num_categories": 5})}


def _libraries():
    """Both packages' libraries, built here; a missing compiler skips."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: neither library can be built")
    if tcorpus.library() is None or native_loader.get_lib() is None:
        pytest.fail("g++ is present but a native library did not build")


def _without_libraries(monkeypatch):
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "_TRIED", True)
    monkeypatch.setattr(tcorpus, "_lib", None)
    monkeypatch.setattr(tcorpus, "_tried", True)


@pytest.mark.parametrize("seed,n,S", [(0, 8, 16), (12345, 37, 6),
                                      (2**62 - 1, 5, 33)])
def test_gen_permutations_equal_the_reference(seed, n, S):
    _libraries()
    got = tcorpus.gen_permutations(seed, n, S)
    np.testing.assert_array_equal(got,
                                  native_loader.gen_permutations(seed, n, S))
    assert got.dtype == np.int32
    assert (np.sort(got, axis=1) == np.arange(S)).all()


@pytest.mark.parametrize("seed,n,S,K,target", [(0, 8, 16, 10, 88),
                                               (7, 37, 6, 5, 18),
                                               (2**62 - 1, 5, 3, 4, 5)])
def test_gen_sum_sequences_equal_the_reference(seed, n, S, K, target):
    _libraries()
    got = tcorpus.gen_sum_sequences(seed, n, S, K, target)
    want = native_loader.gen_sum_sequences(seed, n, S, K, target)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < K
    assert ((got + 1).sum(axis=1) == target).all()
    # the reference's refusal above 512 values a set
    assert tcorpus.gen_sum_sequences(seed, 1, 513, K, 513) is None


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(TASKS))
def test_set_task_batches_equal_the_reference(name, native, monkeypatch):
    """``_gen`` at seeds 0 and 1 and ``eval_batches()[0]`` equal the
    reference's, element for element, on the native path of both packages
    and on the numpy path of both."""
    if native:
        _libraries()
    else:
        _without_libraries(monkeypatch)
    jcls, tcls, extra = TASKS[name]
    jtask = jcls(**TINY, **extra)
    ttask = tcls(**TINY, **extra, device="cpu")
    for seed in (0, 1):
        want = jtask._gen(np.random.default_rng(seed), 37)
        got = ttask._gen(np.random.default_rng(seed), 37)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (37, ttask.set_size)
    np.testing.assert_array_equal(ttask.eval_batches()[0]["x"],
                                  jtask.eval_batches()[0]["x"])
    np.testing.assert_array_equal(
        next(ttask.train_batches(np.random.default_rng(3)))["x"],
        next(jtask.train_batches(np.random.default_rng(3)))["x"])


def test_shuffling_probe_agrees_with_the_native_library():
    """The probe that showed the shuffling task drawing other batches: 8
    sets of 16 from a seed-0 rng, with the native library, now agree; so
    does the first eval batch of the flagship's set size."""
    _libraries()
    args = {**TINY, "set_size": 16}
    jtask = jsm.SetShufflingTask(**args)
    ttask = tsm.SetShufflingTask(**args, device="cpu")
    np.testing.assert_array_equal(
        ttask._gen(np.random.default_rng(0), 8),
        jtask._gen(np.random.default_rng(0), 8))
    np.testing.assert_array_equal(ttask.eval_batches()[0]["x"],
                                  jtask.eval_batches()[0]["x"])


def test_cnf_native_0_turns_the_library_off(monkeypatch):
    """``CNF_NATIVE=0`` keeps the library unbuilt and unloaded, as the
    reference's loader does; the task then takes its numpy path."""
    monkeypatch.setattr(tcorpus, "_lib", None)
    monkeypatch.setattr(tcorpus, "_tried", False)
    monkeypatch.setenv("CNF_NATIVE", "0")
    assert tcorpus.library() is None
    assert tcorpus.gen_permutations(0, 2, 4) is None
    task = tsm.SetShufflingTask(**TINY, device="cpu")
    rng = np.random.default_rng(0)
    rng.integers(2**62)
    np.testing.assert_array_equal(
        task._gen(np.random.default_rng(0), 5),
        np.argsort(rng.random((5, TINY["set_size"])), axis=1))
