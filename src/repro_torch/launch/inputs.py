"""Ragged request sets for serving: a copy of the numpy part of
`repro.launch.inputs`."""
from __future__ import annotations

import numpy as np


def pad_ragged_prompts(prompts) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad a list of variable-length prompts into one batch.

    prompts: sequence of 1-D int token sequences (len >= 1 each).
    Returns (tokens (B, Pmax) int32, lengths (B,) int32); the pad value
    is 0.
    """
    rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if not rows:
        raise ValueError("empty request set")
    if any(r.size == 0 for r in rows):
        raise ValueError("empty prompt in request set: seed with a BOS token")
    pmax = max(r.size for r in rows)
    toks = np.zeros((len(rows), pmax), np.int32)
    lengths = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        toks[i, : r.size] = r
        lengths[i] = r.size
    return toks, lengths


def synthetic_requests(vocab_size: int, n: int, *, min_len: int,
                       max_len: int, seed: int = 0) -> list[np.ndarray]:
    """n random prompts with lengths uniform in [min_len, max_len]: the
    same request sets as the reference's serve CLI for the same seed."""
    if not 1 <= min_len <= max_len:
        raise ValueError(f"need 1 <= min_len <= max_len, got "
                         f"[{min_len}, {max_len}]")
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n)
    return [rng.integers(0, vocab_size, size=int(l)).astype(np.int32)
            for l in lens]
