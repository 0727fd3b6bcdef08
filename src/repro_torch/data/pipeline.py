"""The LM data pipeline (``repro/data/pipeline.py``): deterministic,
restart-safe, host-sharded, in numpy.

A batch is a pure function of (seed, step), so a trainer that resumes
at a checkpointed step N regenerates exactly the batches N, N+1, ...
The code is ``repro``'s numpy, so for a (seed, step) its batches are
bitwise the same as ``repro``'s.  Batches are numpy int32 arrays; the
trainer puts each on its device.  Sources:

  * ``SyntheticSource``: order-1 Markov tokens from a sparse random
    chain, whose cross-entropy floor is known, so a training curve is
    meaningful at any size;
  * ``BinTokenSource``: ``np.memmap`` over a flat token file, sharded
    by ``host``/``num_hosts``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BatchSpec:
    batch: int
    seq_len: int
    vocab: int


class SyntheticSource:
    """Order-1 Markov tokens: the next token is one of ``branching``
    successors of the previous one, each equally likely, so the
    cross-entropy floor is ``log(branching)``."""

    def __init__(self, vocab: int, branching: int = 8, seed: int = 0):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.next_tokens = rng.integers(
            0, vocab, size=(vocab, branching)).astype(np.int32)
        self.branching = branching

    @property
    def entropy_floor(self) -> float:
        return float(np.log(self.branching))

    def batch(self, spec: BatchSpec, step: int, host: int = 0
              ) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((step * 1_000_003 + host) & 0x7FFFFFFF)
        B, S = spec.batch, spec.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        choices = rng.integers(0, self.branching, size=(B, S))
        for t in range(S):
            toks[:, t + 1] = self.next_tokens[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class BinTokenSource:
    """A flat binary token file (uint16 or uint32), memory-mapped; the
    window a step reads is a function of the step alone, so a restart
    needs no iterator state."""

    def __init__(self, path: str, dtype=np.uint16, host: int = 0,
                 num_hosts: int = 1):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.host = host
        self.num_hosts = num_hosts

    def batch(self, spec: BatchSpec, step: int, host: int | None = None
              ) -> dict[str, np.ndarray]:
        host = self.host if host is None else host
        B, S = spec.batch, spec.seq_len
        n = len(self.tokens)
        stride = B * (S + 1)
        # this host's window of this step, wrapping around the file
        base = (step * self.num_hosts + host) * stride
        idx = (base + np.arange(stride)) % (n - 1)
        toks = self.tokens[idx].astype(np.int32).reshape(B, S + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def write_bin_tokens(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    np.asarray(tokens, dtype=dtype).tofile(path)


__all__ = ["BatchSpec", "BinTokenSource", "SyntheticSource",
           "write_bin_tokens"]
