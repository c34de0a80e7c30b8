"""Deterministic synthetic LM token pipeline, a copy of
`repro/data/lm.py` (numpy only).

Tokens follow a first-order Markov chain over a Zipf-distributed vocabulary,
so a language model has real structure to learn (loss decreases) while the
stream stays fully deterministic given (seed, step, shard): any host can
regenerate any shard of any step without coordination, and the two
packages give equal arrays for equal arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    batch: int            # per-host batch
    seq_len: int
    seed: int = 0
    shard: int = 0        # this host's shard index
    num_shards: int = 1

    def __post_init__(self):
        r = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse Markov structure: each token has a few likely successors
        self._succ = r.integers(0, v, size=(v, 4))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._zipf = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int):
        """Batch for `step` on this shard: int32 `tokens` and `targets`
        (b, seq_len), the targets the tokens shifted by one. A pure
        function of its arguments."""
        r = np.random.default_rng(
            (self.seed, step, self.shard, self.num_shards))
        b, s, v = self.batch, self.seq_len, self.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = r.choice(v, size=b, p=self._zipf)
        follow = r.random((b, s)) < 0.8
        succ_pick = r.integers(0, 4, size=(b, s))
        rand_tok = r.choice(v, size=(b, s), p=self._zipf)
        for t in range(s):
            nxt = self._succ[toks[:, t], succ_pick[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand_tok[:, t])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
