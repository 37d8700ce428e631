"""The port's Mamba block (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), on the CPU, on the same numpy inputs
and the reference's weights (Jamba's smoke width: d_model 128, d_inner
256, d_state 8).

Tolerances, with their reasons:

- the causal conv: 1e-5 relative and absolute (a depthwise sum of 4
  products in either library's order); its history rows bit for bit
  (they are copies of the input);
- the selective scan: 1e-5 of the output's largest magnitude. Within a
  chunk the port composes the affine steps by doubling (log2 of the chunk
  length rounds), the reference by ``lax.associative_scan``'s tree: the
  same products and sums associated otherwise, a few float32 ulps of the
  state, which stays below 1 in magnitude per unit input (every decay
  exp(dt·A) < 1);
- the block and its prefill + decode: the layer tolerance of
  ``test_torch_lm.py`` (1e-5 relative and absolute) on the output and on
  the cached state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import ssm as JS
from repro_torch.models import ssm as TS
from repro_torch.models.convert import tensor_from_numpy

# One intra-op thread: the suite runs several workers on the machine's
# cores, and a full torch thread pool in each of them oversubscribes the
# cores and slows the small ops here by two orders of magnitude.
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
CFG = dataclasses.replace(j_get_arch("jamba_v0_1_52b", smoke=True),
                          dtype="float32")


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _params(seed=1):
    jp = JS.mamba_init(jax.random.PRNGKey(seed), CFG)
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches(history):
    rng = np.random.default_rng(int(history))
    di, ck = CFG.mamba_d_inner, CFG.mamba_conv
    x = rng.standard_normal((2, 9, di)).astype(np.float32)
    w = rng.standard_normal((ck, di)).astype(np.float32)
    b = rng.standard_normal((di,)).astype(np.float32)
    hist = rng.standard_normal((2, ck - 1, di)).astype(np.float32) \
        if history else None
    jy, jh = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if hist is None else jnp.asarray(hist))
    ty, th = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if hist is None else torch.from_numpy(hist))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    # a cross-correlation (no flip): output t reads rows t..t+ck-1 of the
    # padded input, the last one weighted by w[ck - 1]
    pad = np.zeros((2, ck - 1, di), np.float32) if hist is None else hist
    xp = np.concatenate([pad, x], 1)
    want = sum(xp[:, j:j + 9] * w[j] for j in range(ck)) + b
    np.testing.assert_allclose(ty.numpy(), want, **F32)


@pytest.mark.parametrize("S", [24, 256, 512])
def test_ssm_scan_one_and_two_chunks(S):
    rng = np.random.default_rng(S)
    B, di, ds = 2, 32, CFG.mamba_d_state
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 3)).astype(
        np.float32)
    Bm, Cm = (rng.standard_normal((B, S, ds)).astype(np.float32)
              for _ in range(2))
    xin = rng.standard_normal((B, S, di)).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds))
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
    args = (dt, Bm, Cm, xin, np.ascontiguousarray(A), h0)
    jh, jy = jax.jit(JS._ssm_scan)(*map(jnp.asarray, args))
    th, ty = TS._ssm_scan(*map(torch.from_numpy, args))
    for got, want in ((ty, jy), (th, jh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_scan_length_not_a_multiple_of_the_chunk_raises():
    dt = torch.zeros((1, 300, 4))
    bm = torch.zeros((1, 300, 2))
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        TS._ssm_scan(dt, bm, bm, dt, torch.zeros((4, 2)),
                     torch.zeros((1, 4, 2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches(dtype):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    jp = JS.mamba_init(jax.random.PRNGKey(2), cfg)
    tp = {k: _t(v) for k, v in jp.items()}
    assert tp["A_log"].dtype == tp["D"].dtype == torch.float32
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, 24, cfg.d_model)), dtype)
    jy, _ = jax.jit(lambda p, x: JS.mamba_apply(p, x, cfg))(jp, x)
    ty, cache = TS.mamba_apply(tp, _t(x), cfg)
    assert cache is None and ty.dtype == tp["in_proj"].dtype
    want = np.asarray(jy).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ty.numpy(), want, **F32)
    else:
        np.testing.assert_allclose(ty.float().numpy(), want, rtol=2.0**-7,
                                   atol=2.0**-7 * np.abs(want).max())


def test_prefill_then_decode_steps_match():
    """A prefill into a zero cache, then one-token steps from it: outputs
    and the cached state (h, conv history) against the reference's, the
    cache written in place."""
    jp, tp = _params(4)
    x = np.random.default_rng(5).standard_normal(
        (2, 21, CFG.d_model)).astype(np.float32)
    step = jax.jit(lambda p, x, c: JS.mamba_apply(p, x, CFG, cache=c))
    jc = JS.mamba_cache_init(CFG, 2)
    tc = TS.mamba_cache_init(CFG, 2)
    storage = {k: v.data_ptr() for k, v in tc.items()}
    at = {}
    for lo, hi in ((0, 16), (16, 17), (17, 18), (18, 21)):
        jy, jc = step(jp, jnp.asarray(x[:, lo:hi]), jc)
        ty, tc = TS.mamba_apply(tp, torch.from_numpy(x[:, lo:hi]), CFG,
                                cache=tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
        for name in ("h", "conv"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **F32)
        at[hi] = {k: v.clone() for k, v in tc.items()}
    assert {k: v.data_ptr() for k, v in tc.items()} == storage
    # one call over the first 18 positions reaches the chained calls' state
    _, one = TS.mamba_apply(tp, torch.from_numpy(x[:, :18]), CFG,
                            cache=TS.mamba_cache_init(CFG, 2))
    for name in ("h", "conv"):
        np.testing.assert_allclose(one[name].numpy(), at[18][name].numpy(),
                                   **F32)
