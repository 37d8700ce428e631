"""The port's RWKV6 block (``repro_torch.models.rwkv6``) against the
reference's (``repro.models.rwkv6``), on the CPU, on the same numpy inputs
and the reference's weights (RWKV6's smoke width: d_model 128, 4 heads of
32).

Both WKV branches run: the step recurrence (any S that is not a multiple
of 128, and every decode step) and the chunked closed form (S > 1, a
multiple of 128: one and two chunks). Tolerances, with their reasons:

- WKV outputs and states: 1e-5 of the largest magnitude (float32 sums of
  up to 128 products a step or a chunk, in either library's order);
- the time and channel mixes, and a prefill then decode steps: the layer
  tolerance of ``test_torch_lm.py`` (float32 1e-5 relative and absolute;
  bfloat16 one bf16 ulp, 2^-7 relative and 2^-7 of the largest magnitude
  absolute);
- the chunked form against the reference's step recurrence: 1e-4 of the
  largest magnitude, since the closed form takes each decay factor as exp
  of a difference of two cumulative sums of up to 128 log-decays, whose
  rounding (~1e-5 of the exponent) the step products do not share.

The port's chunked form is exact for any decay. The reference's clamps
each cumulative log-decay at -25 and so agrees with its own recurrence
only where no chunk decays past e^-25: there the port is held to both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import rwkv6 as JR
from repro_torch.models import rwkv6 as TR
from repro_torch.models.convert import tensor_from_numpy

# One intra-op thread: the suite runs several workers on the machine's
# cores, and a full torch thread pool in each of them oversubscribes the
# cores and slows the small ops here by two orders of magnitude.
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
CFG = dataclasses.replace(j_get_arch("rwkv6_1_6b", smoke=True),
                          dtype="float32")


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got, want, dtype="float32"):
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-7,
                                   atol=2.0**-7 * np.abs(want).max())


def _wkv_inputs(S, seed=0, B=2, H=4, hd=32, log_rate=-2.0):
    """r, k, v, w, u, s0; the decays w = exp(-exp(z + log_rate)), z
    standard normal: at -2 a chunk's cumulative log-decay passes the -25
    clamp, at -5 it stays near -1.4."""
    rng = np.random.default_rng([S, seed])
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, hd))
                       + log_rate)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


def _j_steps(r, k, v, w, u, s0):
    """The reference's step branch, as ``rwkv_time_mix`` writes it."""
    def step(s, inp):
        rt, kt, vt, wt = inp
        kv = kt[..., None] * vt[..., None, :]
        yt = jnp.einsum("bhi,bhij->bhj", rt, s + u[None, :, :, None] * kv)
        return wt[..., None] * s + kv, yt
    s, ys = jax.lax.scan(step, s0, tuple(a.swapaxes(0, 1)
                                         for a in (r, k, v, w)))
    B, S, H, hd = r.shape
    return s, ys.swapaxes(0, 1).reshape(B, S, H * hd)


@pytest.mark.parametrize("S", [24, 128, 256])
def test_wkv_branches_match(S):
    """The port's branch for S against the reference's recurrence, with
    decays strong enough that a chunk's cumulative log-decay passes -25
    (RWKV6's initial decay, ~0.87 a step, does so in ~100 positions); and
    for a chunked S, at decays that stay above the clamp, against the
    reference's chunked form too, which agrees with its recurrence only
    there."""
    fn = TR._wkv_chunked if S % 128 == 0 else TR._wkv_steps
    for log_rate in (-2.0, -5.0):
        args = _wkv_inputs(S, log_rate=log_rate)
        want = [jax.jit(_j_steps)(*map(jnp.asarray, args))]
        if S % 128 == 0 and log_rate == -5.0:
            want.append(jax.jit(JR._wkv_chunked)(*map(jnp.asarray, args)))
        ts, ty = fn(*map(torch.from_numpy, args))
        tol = 1e-5 if fn is TR._wkv_steps else 1e-4
        for js, jy in want:
            for got, ref in ((ty, jy), (ts, js)):
                ref = np.asarray(ref)
                np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                           atol=tol * np.abs(ref).max())
    if S % 128 == 0:    # the reference's clamp where the decays pass it
        args = _wkv_inputs(S, log_rate=-2.0)
        js, jy = jax.jit(JR._wkv_chunked)(*map(jnp.asarray, args))
        _, sy = jax.jit(_j_steps)(*map(jnp.asarray, args))
        gap = float(np.abs(np.asarray(jy) - np.asarray(sy)).max())
        print(f"S={S}: the reference's chunked form departs from its "
              f"recurrence by {gap:.3g} (largest |y| "
              f"{float(np.abs(np.asarray(sy)).max()):.3g})")


def _j_time_mix(p, x, cfg):
    """The reference's time mix as its recurrence at any S: a sequence of
    a multiple of 128 positions runs as S - 1 positions, then one, through
    a zero cache (the no-cache start), both on the step branch."""
    S = x.shape[1]
    tm = jax.jit(lambda p, x, c: JR.rwkv_time_mix(p, x, cfg, cache=c))
    cache = JR.rwkv_cache_init(cfg, x.shape[0])
    if S == 1 or S % 128:
        return tm(p, x, cache)[0]
    y0, cache = tm(p, x[:, :-1], cache)
    return jnp.concatenate([y0, tm(p, x[:, -1:], cache)[0]], axis=1)


@pytest.mark.parametrize("S", [24, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match(S, dtype):
    """The time mix against the reference's recurrence (at S = 128 the
    port takes its chunked branch), and the channel mix."""
    cfg = dataclasses.replace(CFG, dtype=dtype)
    jp = JR.rwkv_init(jax.random.PRNGKey(1), cfg)
    tp = {k: _t(v) for k, v in jp.items()}
    x = jnp.asarray(np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)), dtype)
    ty, cache = TR.rwkv_time_mix(tp, _t(x), cfg)
    assert cache is None
    _close(ty, _j_time_mix(jp, x, cfg), dtype)
    jy, _ = jax.jit(JR.rwkv_channel_mix)(jp, x)
    ty, _ = TR.rwkv_channel_mix(tp, _t(x))
    _close(ty, jy, dtype)


def test_chunked_time_mix_equals_the_reference_above_the_clamp():
    """With the decay's base at -5 (w ≈ 0.993 a step) no chunk decays past
    e^-25, and the reference's chunked time mix is its recurrence: the
    port's chunked branch equals it there too."""
    jp = JR.rwkv_init(jax.random.PRNGKey(2), CFG)
    jp["w0"] = jnp.full_like(jp["w0"], -5.0)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(7).standard_normal(
        (2, 256, CFG.d_model)).astype(np.float32)
    jy, _ = jax.jit(lambda p, x: JR.rwkv_time_mix(p, x, CFG))(jp, x)
    ty, _ = TR.rwkv_time_mix(tp, torch.from_numpy(x), CFG)
    _close(ty, jy)


def test_group_norm_and_shift_match():
    rng = np.random.default_rng(2)
    y = rng.standard_normal((2, 5, 128)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal((128,)).astype(np.float32)
    _close(TR._group_norm(torch.from_numpy(y), torch.from_numpy(scale), 4,
                          1e-6),
           JR._group_norm(jnp.asarray(y), jnp.asarray(scale), 4, 1e-6))
    prev = rng.standard_normal((2, 128)).astype(np.float32)
    for p in (None, prev):
        want = JR._shift(jnp.asarray(y), None if p is None else jnp.asarray(p))
        got = TR._shift(torch.from_numpy(y),
                        None if p is None else torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_then_decode_continues_the_state():
    """A chunked prefill of 128 positions into a zero cache, then
    one-token decode steps, then a 3-token step: the time and channel
    mixes' outputs and the cache (s, x_tm, x_cm) against the reference's
    recurrence (its prefill as 127 positions, then one), written in
    place."""
    jp = JR.rwkv_init(jax.random.PRNGKey(3), CFG)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal(
        (2, 133, CFG.d_model)).astype(np.float32)

    def j_block(p, x, c):
        y, c = JR.rwkv_time_mix(p, x, CFG, cache=c)
        z, c = JR.rwkv_channel_mix(p, x + y, cache=c)
        return y, z, c

    j_step = jax.jit(j_block)
    jc = JR.rwkv_cache_init(CFG, 2)
    tc = TR.rwkv_cache_init(CFG, 2)
    storage = {k: v.data_ptr() for k, v in tc.items()}
    for lo, hi in ((0, 128), (128, 129), (129, 130), (130, 133)):
        if hi == 128:
            jy, jz, jc = j_step(jp, jnp.asarray(x[:, :127]), jc)
            jy1, jz1, jc = j_step(jp, jnp.asarray(x[:, 127:128]), jc)
            jy = jnp.concatenate([jy, jy1], 1)
            jz = jnp.concatenate([jz, jz1], 1)
        else:
            jy, jz, jc = j_step(jp, jnp.asarray(x[:, lo:hi]), jc)
        xt = torch.from_numpy(x[:, lo:hi])
        ty, tc = TR.rwkv_time_mix(tp, xt, CFG, cache=tc)
        tz, tc = TR.rwkv_channel_mix(tp, xt + ty, cache=tc)
        _close(ty, jy)
        _close(tz, jz)
        for name in ("s", "x_tm", "x_cm"):
            _close(tc[name], jc[name])
    assert {k: v.data_ptr() for k, v in tc.items()} == storage
    np.testing.assert_array_equal(tc["x_tm"].numpy(), x[:, -1])
