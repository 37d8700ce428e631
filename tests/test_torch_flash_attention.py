"""The port's flash attention and centroid attention (plain versions, on
the CPU) against the reference's Pallas kernels in interpret mode and its
jnp oracles, over the reference's sweeps (``tests/test_kernels.py``).

The reference's kernels are imported from ``repro.kernels.flash_attention``
directly: ``repro.kernels.ops`` does not import on this jax. Tolerances:
float32 at 2e-4 relative and absolute, the reference's own sweep (an online
softmax against a two-pass one: a few ulps per key, summed over up to 128
keys); bfloat16 at one bf16 ulp (2^-7 relative), since both sides round a
float32 result that differs by a few float32 ulps once. The kernels
themselves run on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# One intra-op thread: the suite runs several workers on the machine's
# cores, and a full torch thread pool in each of them oversubscribes the
# cores and slows the small ops here by two orders of magnitude.
torch.set_num_threads(1)

ATTN_SWEEP = [(1, 4, 4, 128, 32), (2, 8, 2, 100, 64), (1, 6, 1, 65, 64)]
CENTROID_SWEEP = [(1, 4, 4, 1, 48, 32), (2, 4, 2, 3, 100, 64),
                  (1, 3, 1, 40, 33, 16)]
F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-6)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _log_mass(rng, B, Hkv, K, dead=5):
    lm = np.log1p(8.0 * rng.random((B, Hkv, K))).astype(np.float32)
    lm[..., K - dead:] = -1e30
    return lm


@pytest.mark.parametrize("B,Hq,Hkv,S,dh", ATTN_SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_and_oracle(B, Hq, Hkv, S, dh,
                                                         causal):
    rng = np.random.default_rng(S * dh + causal)
    q, k, v = (_normal(rng, (B, h, S, dh)) for h in (Hq, Hkv, Hkv))
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal).numpy()
    pallas = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                            causal=causal, bq=32, bk=32,
                                            interpret=True))
    oracle = np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                           causal=causal))
    assert got.shape == (B, Hq, S, dh) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    np.testing.assert_allclose(got, oracle, **F32_TOL)


def test_flash_attention_plain_bf16_matches_pallas():
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, (1, 2, 64, 32)) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pallas = jfa.flash_attention(jq, jk, jv, bq=32, bk=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (jq, jk, jv))
    got = tops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas.astype(jnp.float32)),
                               **BF16_TOL)


def _split_p_attention(q, k, v, *, causal, parts):
    """The bf16 kernel's arithmetic in plain torch: per 64-key tile, float32
    scores of the bf16 inputs, the running max and sum, P = exp(s - m)
    entering P·V as ``parts`` bf16 parts (bf16(P), then bf16 of what is
    left), V in bf16, float32 sums into a fresh tile accumulator folded
    in as acc·corr + tile; acc / max(l, 1e-30) rounded to bf16."""
    B, Hq, S, dh = q.shape
    rep = Hq // k.shape[1]
    qf = q.float()
    kf, vf = (t.repeat_interleave(rep, 1).float() for t in (k, v))
    m = torch.full((B, Hq, S, 1), -1e30)
    l = torch.zeros((B, Hq, S, 1))
    acc = torch.zeros((B, Hq, S, dh))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, 64):
        keys = torch.arange(k0, min(k0 + 64, S))[None, :]
        s = qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2) * (1.0 / dh ** 0.5)
        if causal:
            s = torch.where(keys <= rows, s, -1e30)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - mn)
        p = torch.exp(s - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        m = mn
        o = torch.zeros_like(acc)
        for _ in range(parts):
            part = p.bfloat16().float()
            o = o + part @ vf[:, :, k0:k0 + 64]
            p = p - part
        acc = acc * corr + o
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _split_p_worst(q, k, v, causal, parts):
    """Largest |split-P emulation − plain| over the bf16 tolerance's limit."""
    want = tref.attention_ref(q, k, v, causal=causal).float().numpy()
    got = _split_p_attention(q, k, v, causal=causal, parts=parts)
    err = np.abs(got.float().numpy() - want)
    return float(np.max(err / (BF16_TOL["atol"] + BF16_TOL["rtol"]
                               * np.abs(want))))


@pytest.mark.parametrize("B,Hq,Hkv,S,dh", ATTN_SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_product_holds_the_bf16_tolerance(B, Hq, Hkv, S, dh, causal):
    """The tensor-core routine's P·V with P as three bf16 parts stays within
    the unchanged bf16 tolerance of the plain version; P as one bf16 part
    (2^-9 of each weight) falls outside it at every one of these shapes,
    which is why the kernel splits P."""
    rng = np.random.default_rng(S * dh + causal)
    q, k, v = (torch.from_numpy(_normal(rng, (B, h, S, dh))).bfloat16()
               for h in (Hq, Hkv, Hkv))
    assert _split_p_worst(q, k, v, causal, parts=3) <= 1.0
    assert _split_p_worst(q, k, v, causal, parts=1) > 1.0


def test_two_part_p_misses_a_short_causal_row():
    """Two bf16 parts (2^-18 of each weight) are not enough either: on
    these inputs of the sweep's (2, 8, 2, 100, 64) shape a near-zero output
    of a short causal row falls outside the tolerance, where three parts
    hold it."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(_normal(rng, (2, h, 100, 64))).bfloat16()
               for h in (8, 2, 2))
    assert _split_p_worst(q, k, v, True, parts=2) > 1.0
    assert _split_p_worst(q, k, v, True, parts=3) <= 1.0


@pytest.mark.parametrize("B,Hq,Hkv,S,K,dh", CENTROID_SWEEP)
def test_centroid_attention_plain_matches_pallas_and_oracle(B, Hq, Hkv, S, K,
                                                            dh):
    """GQA, ragged q/K lengths and 5 dead (-1e30 log-mass) rows."""
    rng = np.random.default_rng(K * dh + S)
    q = _normal(rng, (B, Hq, S, dh))
    c, vc = (_normal(rng, (B, Hkv, K, dh)) for _ in range(2))
    lm = _log_mass(rng, B, Hkv, K)
    got = tops.flash_centroid_attention(
        *map(torch.from_numpy, (q, c, vc, lm))).numpy()
    pallas = np.asarray(jfa.flash_centroid_attention(
        *map(jnp.asarray, (q, c, vc, lm)), bq=32, bk=32, interpret=True))
    oracle = np.asarray(jref.centroid_attention_ref(
        *map(jnp.asarray, (q, c, vc, lm))))
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    np.testing.assert_allclose(got, oracle, **F32_TOL)


@pytest.mark.parametrize("K", [8, 33])
def test_centroid_attention_all_dead_is_mean_of_values(K):
    """Every row dead: the uniform average of v_cent, as the oracle gives
    it (the reference's Pallas kernel also averages its zero padding rows
    in when K is ragged, so the oracle is the contract here)."""
    rng = np.random.default_rng(K)
    q = _normal(rng, (1, 2, 3, 16))
    c, vc = (_normal(rng, (1, 1, K, 16)) for _ in range(2))
    lm = np.full((1, 1, K), -1e30, np.float32)
    got = tops.flash_centroid_attention(
        *map(torch.from_numpy, (q, c, vc, lm))).numpy()
    oracle = np.asarray(jref.centroid_attention_ref(
        *map(jnp.asarray, (q, c, vc, lm))))
    np.testing.assert_allclose(got, oracle, **F32_TOL)
    np.testing.assert_allclose(got, np.broadcast_to(vc.mean(2, keepdims=True),
                                                    got.shape), **F32_TOL)
    assert np.all(np.isfinite(got))


def test_centroid_attention_equals_attention_with_unit_mass():
    """log_mass = 0 everywhere is plain non-causal attention."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, (2, 4, 5, 32)))
    k, v = (torch.from_numpy(_normal(rng, (2, 2, 5, 32))) for _ in range(2))
    np.testing.assert_allclose(
        tref.centroid_attention_ref(q, k, v, torch.zeros(2, 2, 5)).numpy(),
        tref.attention_ref(q, k, v, causal=False).numpy(), **F32_TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch the kernel or raise: a CPU tensor is refused
    there (``ops`` takes the plain version for it first)."""
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_centroid_attention(q, q, q, torch.zeros(1, 2, 4))
