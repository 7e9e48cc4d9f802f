"""Data pipeline: the synthetic LM source, the byte corpus, the synthetic
classification set of the utility experiments, packing and the DP
Poisson sampler.

A numpy-only copy of `repro.data.pipeline`, so the port imports nothing
of the JAX package. The streams
are bit for bit the reference's for the same seeds (the parity tests check
it).

DP-SGD's privacy accounting assumes POISSON subsampling: each example
joins the minibatch independently with probability rho = B/N.
`PoissonSampler` draws exactly that; batches are padded to a fixed size
with rows whose targets are all -1, so their loss and gradient are
exactly zero and they consume no sensitivity.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Markov chain with Zipf marginals; next-token structure is learnable."""

    vocab_size: int
    num_docs: int = 1024
    doc_len: int = 512
    seed: int = 0
    order_mix: float = 0.8  # prob of following the planted bigram table

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._marginal = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._succ = rng.integers(0, v, size=(v,))  # planted bigram successor
        self._rng = rng

    def documents(self) -> list[np.ndarray]:
        v = self.vocab_size
        docs = []
        for _ in range(self.num_docs):
            toks = np.empty(self.doc_len, np.int32)
            toks[0] = self._rng.choice(v, p=self._marginal)
            follow = self._rng.random(self.doc_len) < self.order_mix
            rand = self._rng.choice(v, size=self.doc_len, p=self._marginal)
            for t in range(1, self.doc_len):
                toks[t] = self._succ[toks[t - 1]] if follow[t] else rand[t]
            docs.append(toks)
        return docs


@dataclasses.dataclass
class ByteCorpus:
    """Byte-level 'tokenizer' over a text blob (vocab 256 + BOS=256)."""

    text: str
    doc_sep: str = "\n\n"

    @property
    def vocab_size(self) -> int:
        return 257

    def documents(self) -> list[np.ndarray]:
        return [np.frombuffer(d.encode("utf-8", "ignore"), dtype=np.uint8)
                .astype(np.int32)
                for d in self.text.split(self.doc_sep) if d]


@dataclasses.dataclass
class SyntheticClassification:
    """Gaussian clusters with margin; per-example DP utility experiments."""

    num_classes: int = 10
    dim: int = 32
    num_examples: int = 2048
    noise: float = 0.8
    seed: int = 0

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        centers = rng.normal(size=(self.num_classes, self.dim))
        centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
        y = rng.integers(0, self.num_classes, size=self.num_examples)
        x = centers[y] + self.noise * rng.normal(
            size=(self.num_examples, self.dim))
        return x.astype(np.float32), y.astype(np.int32)


def pack_documents(docs: list[np.ndarray], seq_len: int, *,
                   bos: int | None = None) -> np.ndarray:
    """Concatenate docs (optionally BOS-separated) into (N, seq_len) rows."""
    parts = []
    for d in docs:
        if bos is not None:
            parts.append(np.array([bos], np.int32))
        parts.append(d.astype(np.int32))
    stream = np.concatenate(parts)
    n = len(stream) // seq_len
    return stream[: n * seq_len].reshape(n, seq_len)


def make_lm_batch(rows: np.ndarray, idx: np.ndarray, pad_to: int
                  ) -> dict[str, np.ndarray]:
    """Gather rows -> {'tokens', 'targets'} padded to `pad_to` examples.

    Padding rows get tokens=0 and targets=-1 everywhere: their per-example
    loss and gradient are identically zero."""
    take = rows[idx[:pad_to]]
    b = take.shape[0]
    tokens = np.zeros((pad_to, rows.shape[1]), np.int32)
    targets = np.full((pad_to, rows.shape[1]), -1, np.int32)
    tokens[:b] = take
    targets[:b, :-1] = take[:, 1:]
    return {"tokens": tokens, "targets": targets}


@dataclasses.dataclass
class PoissonSampler:
    """Poisson subsampling: every example independently with prob `rate`.

    Batches have random size ~ Binomial(N, rate); `max_batch` fixes the
    shape (overflowing examples are dropped and the event counted)."""

    num_examples: int
    rate: float
    max_batch: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.overflow_count = 0
        self.draws = 0  # batches drawn so far (position in the stream)

    def next_indices(self) -> np.ndarray:
        mask = self._rng.random(self.num_examples) < self.rate
        idx = np.nonzero(mask)[0]
        self._rng.shuffle(idx)
        if len(idx) > self.max_batch:
            self.overflow_count += 1
            idx = idx[: self.max_batch]
        self.draws += 1
        return idx.astype(np.int64)

    def state(self) -> dict:
        """JSON-safe snapshot; `restore` continues the exact stream."""
        return {
            "rng": json.dumps(self._rng.bit_generator.state),
            "draws": self.draws,
            "overflow_count": self.overflow_count,
            "num_examples": self.num_examples,
            "rate": self.rate,
            "max_batch": self.max_batch,
        }

    def restore(self, state: dict) -> None:
        """Inverse of `state()`. Refuses a snapshot from a sampler over a
        different corpus/rate — that would silently change q mid-ledger."""
        for field in ("num_examples", "max_batch"):
            if int(state[field]) != getattr(self, field):
                raise ValueError(
                    f"sampler state mismatch: {field} was {state[field]}, "
                    f"this sampler has {getattr(self, field)}")
        if abs(float(state["rate"]) - self.rate) > 1e-12:
            raise ValueError(
                f"sampler state mismatch: rate was {state['rate']}, "
                f"this sampler has {self.rate}")
        self._rng.bit_generator.state = json.loads(state["rng"])
        self.draws = int(state["draws"])
        self.overflow_count = int(state["overflow_count"])
