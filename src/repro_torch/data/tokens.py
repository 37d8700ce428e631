"""Deterministic, skip-ahead LM token pipeline (the counterpart of
``repro.data.tokens``).

Every batch is a pure function of (seed, step, host): no iterator state,
so a restart from a checkpoint resumes bit for bit, and any host can
compute its own batch. The draws come from a CPU ``torch.Generator``
seeded by ``batch_seed(seed, step, host)``; the port does not reproduce
``jax.random``'s draws (ROADMAP.md's parity contract), so the batches are
the reference's function of other draws. ``tokens_from_draws`` is that
function, and tests feed it the reference's own draws.

The synthetic "language" is learnable: within a segment, token t+1 is an
affine function of token t mod vocab, with random segment restarts, so a
small model's loss drops quickly.

As in the reference, host h of n draws its own ``batch // n`` rows:
``host_batch`` is not a slice of ``global_batch``. A data-parallel
trainer that needs the slice takes rows of ``global_batch``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def batch_seed(seed: int, step: int, host: int) -> int:
    """The generator seed of one batch: a fixed function of (seed, step,
    host) that no two of them share by accident."""
    state = np.random.SeedSequence([int(seed), int(step), int(host)])
    return int(state.generate_state(1, np.uint64)[0])


def _generator(seed: int, step: int, host: int) -> torch.Generator:
    return torch.Generator().manual_seed(batch_seed(seed, step, host))


def tokens_from_draws(start, restart, fresh, *, vocab_size: int, mult: int,
                      add: int):
    """The reference's recurrence on given draws: start (b, 1), restart
    (b, S) bool, fresh (b, S) integers (numpy, tensors or JAX arrays).
    ``toks[:, t] = fresh[:, t]`` where ``restart[:, t]``, else
    ``(toks[:, t-1] · mult + add) mod vocab`` (``toks[:, -1]`` is
    ``start``), in int32 arithmetic that wraps as the reference's does;
    inputs are ``start`` then ``toks[:, :-1]``, labels ``toks``. Returns
    {"inputs", "labels"}: (b, S) int32 CPU tensors."""
    start = np.asarray(start).astype(np.int64)
    restart = np.asarray(restart).astype(bool)
    fresh = np.asarray(fresh).astype(np.int64)
    toks = np.empty(fresh.shape, np.int64)
    cur = start[:, 0]
    for t in range(fresh.shape[1]):
        nxt = (cur * mult + add) & 0xFFFFFFFF            # int32 wrap-around
        nxt = np.where(nxt >= 1 << 31, nxt - (1 << 32), nxt) % vocab_size
        cur = np.where(restart[:, t], fresh[:, t], nxt)
        toks[:, t] = cur
    inputs = np.concatenate([start, toks[:, :-1]], axis=1)
    return {"inputs": torch.from_numpy(inputs.astype(np.int32)),
            "labels": torch.from_numpy(toks.astype(np.int32))}


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch: int            # global batch
    seq_len: int
    seed: int = 0
    mult: int = 31
    add: int = 7
    restart_prob: float = 0.05

    def global_batch(self, step: int):
        return self._make(step, 0, 1)

    def host_batch(self, step: int, host_id: int, num_hosts: int):
        """Host ``host_id``'s ``batch // num_hosts`` rows, drawn from its
        own generator (as the reference's)."""
        return self._make(step, host_id, num_hosts)

    def draws(self, step: int, host_id: int = 0, num_hosts: int = 1):
        """(start (b, 1), restart (b, S) bool, fresh (b, S)) of one batch."""
        b = self.batch // num_hosts
        gen = _generator(self.seed, step, host_id)
        start = torch.randint(0, self.vocab_size, (b, 1), generator=gen)
        restart = torch.rand((b, self.seq_len), generator=gen) \
            < self.restart_prob
        fresh = torch.randint(0, self.vocab_size, (b, self.seq_len),
                              generator=gen)
        return start, restart, fresh

    def _make(self, step, host_id: int, num_hosts: int):
        return tokens_from_draws(*self.draws(step, host_id, num_hosts),
                                 vocab_size=self.vocab_size, mult=self.mult,
                                 add=self.add)


@dataclasses.dataclass(frozen=True)
class EmbeddingPipeline:
    """Stub-frontend pipeline (vlm/audio): drawn frame/patch embeddings
    (bfloat16) and token labels, with the same determinism contract."""
    d_model: int
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def global_batch(self, step: int):
        gen = _generator(self.seed, step, 0)
        emb = torch.randn((self.batch, self.seq_len, self.d_model),
                          generator=gen).to(torch.bfloat16)
        labels = torch.randint(0, self.vocab_size,
                               (self.batch, self.seq_len), generator=gen)
        return {"inputs": emb, "labels": labels.to(torch.int32)}
