"""The port's token pipelines (``repro_torch.data.tokens``) against the
reference's (``repro.data.tokens``).

Draws are injected, not reproduced (ROADMAP.md's parity contract): the
reference's own ``jax.random`` draws of a batch go into the port's
``tokens_from_draws``, which must give the reference's batch bit for bit.
The port's batches (its own draws) are held to the reference's
properties: a pure function of (seed, step, host), the label shift, the
learnable affine structure (``tests/test_substrate.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro_torch.data.tokens import (EmbeddingPipeline, TokenPipeline,
                                     batch_seed, tokens_from_draws)

torch.set_num_threads(1)


def _reference_draws(tp: JTokenPipeline, step: int, host: int, hosts: int):
    """The reference's ``_make`` draws, by its own key derivation."""
    b = tp.batch // hosts
    key = jax.random.fold_in(jax.random.PRNGKey(tp.seed),
                             jnp.asarray(step, jnp.int32))
    key = jax.random.fold_in(key, host)
    k0, k1, k2 = jax.random.split(key, 3)
    start = jax.random.randint(k0, (b, 1), 0, tp.vocab_size)
    restart = jax.random.uniform(k1, (b, tp.seq_len)) < tp.restart_prob
    fresh = jax.random.randint(k2, (b, tp.seq_len), 0, tp.vocab_size)
    return np.asarray(start), np.asarray(restart), np.asarray(fresh)


@pytest.mark.parametrize("vocab,mult,add,restart_prob", [
    (97, 31, 7, 0.05),
    (151_936, 31, 7, 0.05),
    (1 << 30, 31, 7, 0.2),          # cur · mult overflows int32: it wraps
    (1000, 1 << 28, 123_456_789, 0.0),
])
@pytest.mark.parametrize("step,host,hosts", [(0, 0, 1), (5, 1, 2)])
def test_recurrence_on_the_reference_draws_is_bit_exact(vocab, mult, add,
                                                        restart_prob, step,
                                                        host, hosts):
    jtp = JTokenPipeline(vocab_size=vocab, batch=4, seq_len=48, seed=3,
                         mult=mult, add=add, restart_prob=restart_prob)
    want = jtp.host_batch(step, host, hosts)
    got = tokens_from_draws(*_reference_draws(jtp, step, host, hosts),
                            vocab_size=vocab, mult=mult, add=add)
    for k in ("inputs", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_token_pipeline_deterministic_skip_ahead():
    tp = TokenPipeline(vocab_size=128, batch=4, seq_len=16, seed=3)
    b1, b2 = tp.global_batch(5), tp.global_batch(5)
    assert torch.equal(b1["inputs"], b2["inputs"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(b1["inputs"], tp.global_batch(6)["inputs"])
    assert not torch.equal(b1["inputs"], TokenPipeline(
        vocab_size=128, batch=4, seq_len=16, seed=4).global_batch(5)["inputs"])
    # any host computes its own batch, the same every time
    h = tp.host_batch(5, 1, 2)
    assert h["inputs"].shape == (2, 16)
    assert torch.equal(h["inputs"], tp.host_batch(5, 1, 2)["inputs"])
    assert not torch.equal(h["inputs"], tp.host_batch(5, 0, 2)["inputs"])
    assert len({batch_seed(3, s, hh) for s in range(50) for hh in range(4)}) \
        == 200


def test_token_pipeline_learnable_structure():
    """labels are (mostly) an affine function of inputs — learnable."""
    tp = TokenPipeline(vocab_size=97, batch=8, seq_len=64, seed=0)
    b = tp.global_batch(0)
    pred = (b["inputs"].numpy().astype(np.int64) * tp.mult + tp.add) % 97
    agree = (pred == b["labels"].numpy()).mean()
    assert agree > 0.85                                # 5% restarts
    assert 0 <= int(b["labels"].min()) and int(b["labels"].max()) < 97


def test_token_pipeline_labels_shift():
    tp = TokenPipeline(vocab_size=97, batch=2, seq_len=32, seed=1)
    b = tp.global_batch(0)
    assert torch.equal(b["inputs"][:, 1:], b["labels"][:, :-1])
    start = tp.draws(0)[0]
    assert torch.equal(b["inputs"][:, :1], start.to(torch.int32))


def test_embedding_pipeline_shapes_and_determinism():
    ep = EmbeddingPipeline(d_model=16, vocab_size=50, batch=3, seq_len=8,
                           seed=2)
    b = ep.global_batch(4)
    assert b["inputs"].shape == (3, 8, 16)
    assert b["inputs"].dtype == torch.bfloat16
    assert b["labels"].shape == (3, 8) and b["labels"].dtype == torch.int32
    assert 0 <= int(b["labels"].min()) and int(b["labels"].max()) < 50
    again = ep.global_batch(4)
    assert torch.equal(b["inputs"], again["inputs"])
    assert torch.equal(b["labels"], again["labels"])
    assert not torch.equal(b["inputs"], ep.global_batch(5)["inputs"])
