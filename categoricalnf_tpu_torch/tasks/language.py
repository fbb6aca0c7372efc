"""Character-level language modeling: PTB, text8 and a synthetic Markov
corpus (counterpart of ``categoricalnf_tpu/tasks/language.py``).

The loaders read the standard files from ``data_dir`` when they are there
(``ptb.char.{train,valid,test}.txt``, or ``text8``) and otherwise fall back
to a synthetic first-order Markov source, whose exact entropy rate is the
analytic bits/char optimum.  The synthetic corpus and the training crops
come from the port's copy of the reference's C++ generators
(``data/corpus.cpp``), stream for stream the reference's; numpy where that
library cannot be built, as in the reference.

The model is a time-autoregressive mixture-CDF flow whose causal nets are
LSTMs or causal transformers (``flows.AutoregressiveMixtureCDF``,
``networks.CausalLSTM``, ``networks.CausalTransformer``: ``net``), with a
logistic, normal or learned HMM prior on top.  Likelihoods are the
importance-sampled bits/char; sampling rolls the nets one character at a
time (the transformer through its KV cache).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from categoricalnf_tpu_torch import flows
from categoricalnf_tpu_torch.data import corpus as native
from categoricalnf_tpu_torch.encodings import create_encoding
from categoricalnf_tpu_torch.models.categorical_flow import CategoricalFlow
from categoricalnf_tpu_torch.networks import CausalLSTM, CausalTransformer
from categoricalnf_tpu_torch.training.task import TaskTemplate
from categoricalnf_tpu_torch.utils.device import resolve_device

PTB_FILES = {"train": "ptb.char.train.txt", "valid": "ptb.char.valid.txt",
             "test": "ptb.char.test.txt"}


class CharCorpus:
    """Token streams and vocabulary of the train/valid/test splits; a
    synthetic corpus also carries its transition matrix, stationary
    distribution and entropy rate."""

    def __init__(self, splits: dict, vocab: list, name: str,
                 analytic_bpc: Optional[float] = None,
                 transition_matrix: Optional[np.ndarray] = None,
                 stationary: Optional[np.ndarray] = None):
        self.splits = splits
        self.vocab = vocab
        self.name = name
        self.analytic_bpc = analytic_bpc
        self.transition_matrix = transition_matrix
        self.stationary = stationary

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def load_ptb_char(data_dir: str) -> CharCorpus:
    """Mikolov's character-level PTB: whitespace-separated tokens ('_' is
    the original space), each token one symbol."""
    tokens = {}
    for split, fname in PTB_FILES.items():
        with open(os.path.join(data_dir, fname)) as f:
            tokens[split] = f.read().split()
    chars = sorted(set(tokens["train"]))
    idx = {c: i for i, c in enumerate(chars)}
    for split in ("valid", "test"):
        oov = set(tokens[split]) - set(chars)
        if oov:
            raise ValueError(
                f"PTB {split} split has symbols absent from the train "
                f"vocab: {sorted(oov)!r}; refusing to drop them")
    splits = {k: np.asarray([idx[c] for c in v], np.int32)
              for k, v in tokens.items()}
    return CharCorpus(splits, chars, "ptb_char")


def load_text8(data_dir: str) -> CharCorpus:
    """text8: 100M characters of a-z and space, split 90/5/5."""
    with open(os.path.join(data_dir, "text8")) as f:
        text = f.read()
    chars = sorted(set(text))
    idx = {c: i for i, c in enumerate(chars)}
    arr = np.asarray([idx[c] for c in text], np.int32)
    n = len(arr)
    a, b = int(n * 0.9), int(n * 0.95)
    return CharCorpus({"train": arr[:a], "valid": arr[a:b],
                       "test": arr[b:]}, chars, "text8")


def synthetic_markov_corpus(vocab_size: int = 27, length: int = 20_000_000,
                            seed: int = 0,
                            concentration: float = 0.3) -> CharCorpus:
    """A first-order Markov chain with Dirichlet rows, one chain of
    ``length`` split 90/5/5; its stationary entropy rate is the optimum
    any model can reach."""
    rng = np.random.default_rng(seed)
    P = rng.dirichlet([concentration] * vocab_size, size=vocab_size)
    # the stationary distribution: the left eigenvector of P at 1
    evals, evecs = np.linalg.eig(P.T)
    i = int(np.argmin(np.abs(evals - 1.0)))
    pi = np.real(evecs[:, i])
    pi = np.abs(pi) / np.abs(pi).sum()
    ent = -(pi[:, None] * P * np.log2(np.maximum(P, 1e-30))).sum()

    state = int(rng.choice(vocab_size, p=pi))
    out = native.markov_rollout(seed + 17, P, length, state)
    if out is None:
        out = np.empty(length, np.int32)
        cdf = np.cumsum(P, axis=1)
        u = rng.random(length)
        for t in range(length):
            state = int(np.searchsorted(cdf[state], u[t]))
            out[t] = state
    a, b = int(length * 0.9), int(length * 0.95)
    vocab = [chr(ord("a") + i) if i < 26 else "_" for i in range(vocab_size)]
    return CharCorpus({"train": out[:a], "valid": out[a:b], "test": out[b:]},
                      vocab, "synthetic_markov", analytic_bpc=float(ent),
                      transition_matrix=P, stationary=pi)


def load_corpus(name: str, data_dir: Optional[str] = None) -> CharCorpus:
    data_dir = data_dir or os.environ.get("CNF_DATA_DIR", "data")
    if name == "ptb":
        if os.path.exists(os.path.join(data_dir, PTB_FILES["train"])):
            return load_ptb_char(data_dir)
        return synthetic_markov_corpus(vocab_size=50, seed=1)
    if name == "text8":
        if os.path.exists(os.path.join(data_dir, "text8")):
            return load_text8(data_dir)
        return synthetic_markov_corpus(vocab_size=27, seed=2)
    if name == "synthetic":
        return synthetic_markov_corpus()
    raise ValueError(f"unknown corpus {name!r}")


def build_lm_flow(dim: int, num_layers: int = 2, hidden_dim: int = 512,
                  lstm_layers: int = 2, num_mixtures: int = 16,
                  compute_dtype: str = "bfloat16", scan_blocks: bool = True,
                  channel_coupling: bool = True, net: str = "lstm",
                  seq_len: int = 512, input_feats: int = 0,
                  prior: str = "logistic", prior_states: int = 32, *,
                  generator=None) -> flows.FlowModel:
    """The LM flow: autoregressive in time and, with ``channel_coupling``,
    a coupling in channels; a block is [ActNorm, InvertibleLinear, AR
    layer of parity 0, SoftClamp] and the same with parity 1 (one AR layer
    of parity None without ``channel_coupling``).  ``num_layers`` blocks,
    as one ``ScannedBlocks`` when ``scan_blocks`` and more than one.
    ``net`` picks the causal backbone: ``lstm`` (``lstm_layers`` LSTM
    layers) or ``transformer`` (``lstm_layers`` blocks of 4 heads, its KV
    cache ``seq_len`` long)."""
    out_dim = dim * (2 + 3 * num_mixtures)

    def make_net(parity):
        extra = dim if parity is not None else 0
        if net == "lstm":
            return CausalLSTM(dim + input_feats, out_dim,
                              hidden_dim=hidden_dim, num_layers=lstm_layers,
                              extra_dim=extra, compute_dtype=compute_dtype,
                              generator=generator)
        if net == "transformer":
            return CausalTransformer(dim + input_feats, out_dim,
                                     hidden_dim=hidden_dim,
                                     num_layers=lstm_layers, max_len=seq_len,
                                     extra_dim=extra,
                                     compute_dtype=compute_dtype,
                                     generator=generator)
        raise ValueError(f"unknown LM net {net!r}")

    def ar(parity):
        causal = make_net(parity)
        return [flows.ActNorm(dim),
                flows.InvertibleLinear(dim, generator=generator),
                flows.AutoregressiveMixtureCDF(
                    causal, dim, num_mixtures=num_mixtures, parity=parity,
                    input_feats=input_feats, generator=generator),
                flows.SoftClamp()]

    def block():
        return ar(0) + ar(1) if channel_coupling else ar(None)

    top = flows.create_prior(prior, dim, generator=generator,
                             **({"num_states": prior_states}
                                if prior == "hmm" else {}))
    if scan_blocks and num_layers > 1:
        return flows.FlowModel(
            [flows.ScannedBlocks([block() for _ in range(num_layers)])],
            prior=top)
    return flows.FlowModel([layer for _ in range(num_layers)
                            for layer in block()], prior=top)


@dataclasses.dataclass
class LanguageModelingTask(TaskTemplate):
    corpus_name: str = "ptb"
    data_dir: Optional[str] = None
    seq_len: int = 256
    batch_size: int = 128
    encoding_dim: int = 3
    encoding_name: str = "mixture"
    num_layers: int = 2
    hidden_dim: int = 512
    lstm_layers: int = 2
    num_mixtures: int = 16
    net: str = "lstm"
    # V-component soft-classifier features of z_{t-1} fed to the causal
    # nets (0 = off)
    input_feats: int = 0
    # the top of the flow: "logistic", "gaussian" or "hmm"
    prior: str = "logistic"
    prior_states: int = 32
    eval_batches_count: int = 8
    compute_dtype: str = "bfloat16"
    seed: int = 0
    device: Optional[str] = None
    name: str = "language_modeling"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.corpus = load_corpus(self.corpus_name, self.data_dir)
        self.name = f"lm_{self.corpus.name}"
        self.init_params(self.seed)

    def build_model(self, generator):
        enc = create_encoding(self.encoding_name, self.corpus.vocab_size,
                              self.encoding_dim, generator=generator)
        flow = build_lm_flow(enc.dim, self.num_layers, self.hidden_dim,
                             self.lstm_layers, self.num_mixtures,
                             self.compute_dtype, net=self.net,
                             seq_len=self.seq_len,
                             input_feats=self.input_feats, prior=self.prior,
                             prior_states=self.prior_states,
                             generator=generator)
        return CategoricalFlow(enc, flow)

    def _chunks(self, split: str, rng: np.random.Generator,
                n: int) -> np.ndarray:
        stream = self.corpus.splits[split]
        out = native.chunk_corpus(int(rng.integers(2**62)), stream, n,
                                  self.seq_len)
        if out is not None:
            return out
        starts = rng.integers(0, len(stream) - self.seq_len - 1, n)
        return np.stack([stream[s:s + self.seq_len] for s in starts])

    def train_batches(self, rng: np.random.Generator) -> Iterator[dict]:
        while True:
            yield {"x": self._chunks("train", rng, self.batch_size)}

    def eval_batches(self) -> list:
        rng = np.random.default_rng(99)
        return [{"x": self._chunks("valid", rng, self.batch_size)}
                for _ in range(self.eval_batches_count)]

    def test_batches(self) -> list:
        rng = np.random.default_rng(101)
        return [{"x": self._chunks("test", rng, self.batch_size)}
                for _ in range(self.eval_batches_count)]

    def analytic_optimum_bpd(self) -> Optional[float]:
        return self.corpus.analytic_bpc

    @torch.no_grad()
    def sample_text(self, num: int = 4, temperature: float = 1.0,
                    generator=None) -> list:
        """``num`` sampled sequences of ``seq_len`` characters."""
        x = self.model.sample(num, self.seq_len, temperature=temperature,
                              generator=generator).cpu().numpy()
        return ["".join(self.corpus.vocab[i] for i in row) for row in x]

    @torch.no_grad()
    def sample_metrics(self, generator=None, num_samples: int = 256,
                       temperature: float = 1.0) -> dict:
        """Sample quality against the known generating kernel (synthetic
        corpora only), from full batches of ``batch_size`` samples:
        ``unigram_tv``, the total variation between the sampled character
        marginal and the stationary distribution, and ``bigram_kl_bits``,
        the occupancy-weighted KL (bits a transition) of the sampled
        transition estimate from the true kernel (biased upward by the
        estimate's noise, so comparable at equal ``num_samples``)."""
        P = self.corpus.transition_matrix
        if P is None:
            return {}
        K = self.corpus.vocab_size
        counts = np.zeros((K, K), np.float64)
        done = 0
        while done < num_samples:
            b = min(self.batch_size, num_samples - done)
            x = self.model.sample(self.batch_size, self.seq_len,
                                  temperature=temperature,
                                  generator=generator).cpu().numpy()[:b]
            np.add.at(counts, (x[:, :-1].ravel(), x[:, 1:].ravel()), 1.0)
            done += b
        occ = counts.sum(1)
        p_occ = occ / occ.sum()
        phat = (counts + 1e-3) / (occ[:, None] + 1e-3 * K)
        kl_rows = (phat * np.log2(phat / np.maximum(P, 1e-30))).sum(1)
        marg = counts.sum(0) + counts.sum(1)
        marg = marg / marg.sum()
        tv = 0.5 * np.abs(marg - self.corpus.stationary).sum()
        return {"unigram_tv": float(tv),
                "bigram_kl_bits": float((p_occ * kl_rows).sum()),
                "metric_num_samples": float(done)}

    def sample_artifacts(self, out_dir: str, generator=None) -> None:
        texts = self.sample_text(8, generator=generator)
        with open(os.path.join(out_dir, "samples.txt"), "w") as f:
            for t in texts:
                f.write(t + "\n---\n")
