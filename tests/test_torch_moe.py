"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``), on the CPU, on the same numpy inputs
and the reference's weights.

The dispatch is integer work and is held bit for bit from the same
router probabilities: the top-k expert ids (``lax.top_k``: the lower id
first on ties, forced here), the stable sort by expert (the token of each
sorted pair), the capacity positions, the buffer rows and which pairs are
dropped; the gates too, since both sides take the same float32 ops on the
same probabilities. The layer's outputs are held as ``test_torch_lm.py``
holds layers:

- float32: 1e-5 relative and absolute (one library's matmul against the
  other's, a few float32 ulps); the aux loss likewise;
- bfloat16: one bf16 ulp (2^-7 relative, 2^-7 of the largest magnitude
  absolute);
- fp8 expert weights (``moe_weight_dtype="float8_e4m3fn"``): both sides
  round the weights and the expert inputs to fp8 the same way and multiply
  them exactly in float32, but the second product's input, silu(h)·u, is
  rounded to fp8 after float32 sums that differ by an ulp, and where that
  lands on either side of an fp8 rounding boundary one term moves by an
  fp8 ulp (2^-3 relative): 2^-3 of the largest magnitude absolute, with
  at most 1 % of the elements off by more than the float32 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

# One intra-op thread: the suite runs several workers on the machine's
# cores, and a full torch thread pool in each of them oversubscribes the
# cores and slows the small ops here by two orders of magnitude.
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
SMOKES = ["jamba_v0_1_52b", "kimi_k2_1t_a32b", "llama4_maverick_400b_a17b"]


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _cfg(arch="kimi_k2_1t_a32b", dtype="float32", **kw):
    return dataclasses.replace(j_get_arch(arch, smoke=True), dtype=dtype,
                               **kw)


def _params(cfg, seed=1):
    jp = JMoE.moe_init(jax.random.PRNGKey(seed), cfg)
    return jp, {k: _t(v) for k, v in jp.items()}


def _probs(rng, T, e, ties=False):
    logits = rng.standard_normal((T, e)).astype(np.float32) * 2
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    if ties:                                    # (rows that exist)
        p[0] = 1.0 / e                          # every expert tied
        p[1:2, 1:4] = p[1:2, 1:2]               # three tied, at any rank
        p[2:3, -1] = p[2:3, 0] = p[2:3].max(initial=0.0)   # first and last
    return p


_j_dispatch = jax.jit(JMoE._dispatch_local, static_argnums=(2, 3, 4))


def _dispatch_equal(xg, probs, k, e, cap):
    jbuf, jst, jsg, jkeep, jslot = _j_dispatch(jnp.asarray(xg),
                                               jnp.asarray(probs), k, e, cap)
    buf, st, sg, keep, slot, order = TMoE._dispatch_local(
        torch.from_numpy(xg), torch.from_numpy(probs), k, e, cap)
    np.testing.assert_array_equal(
        TMoE.top_k(torch.from_numpy(probs), k)[1].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1]))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(sg.numpy(), np.asarray(jsg))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    # order maps sorted positions to flat (token, choice) pairs
    np.testing.assert_array_equal((order // k).numpy(), np.asarray(jst))
    return keep


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("T,e,k", [(48, 4, 2), (33, 8, 2), (40, 16, 8),
                                   (1, 16, 2)])
def test_dispatch_integers_bit_identical(T, e, k, ties):
    rng = np.random.default_rng([T, e, k, ties])
    xg = rng.standard_normal((T, 12)).astype(np.float32)
    probs = _probs(rng, T, e, ties)
    cap = TMoE.capacity(_cfg(moe_num_experts=e, moe_top_k=k), T)
    keep = _dispatch_equal(xg, probs, k, e, cap)
    assert bool(keep.all()) or T * k > cap


def test_forced_ties_take_the_lower_expert_first():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.1, 0.1, 0.4]])
    vals, ids = TMoE.top_k(probs, 2)
    assert ids.tolist() == [[0, 1], [1, 2], [0, 3]]
    assert vals[1].tolist() == pytest.approx([0.3, 0.3])


def test_capacity_overflow_drops_the_later_tokens():
    """Every token prefers expert 0: it keeps the first ``cap`` pairs in
    token order, the rest go to the spare row, and the layer drops them
    as the reference does."""
    cfg = _cfg("jamba_v0_1_52b")
    e, k, T = cfg.moe_num_experts, cfg.moe_top_k, 64
    cap = TMoE.capacity(cfg, T)
    assert cap == 40
    rng = np.random.default_rng(3)
    probs = _probs(rng, T, e)
    probs[:, 0] += 2.0
    probs /= probs.sum(-1, keepdims=True)
    xg = rng.standard_normal((T, 8)).astype(np.float32)
    keep = _dispatch_equal(xg, probs.astype(np.float32), k, e, cap)
    assert int((~keep).sum()) == T - cap
    # the layer: a router that sends every token to expert 0 first
    jp, tp = _params(cfg)
    x = rng.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    bias = np.zeros((cfg.d_model, e), np.float32)
    bias[:, 0] = np.sign(x.reshape(T, -1).mean(0)) * 0.5
    jp["router"] = jp["router"] + bias
    tp["router"] = _t(jp["router"])
    jy, jaux = jax.jit(lambda p, x: JMoE.moe_apply(p, x, cfg))(jp, x)
    ty, taux = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    dropped = int(TMoE.dropped(cfg, torch.from_numpy(x), tp))
    assert dropped > 0
    print(f"capacity {cap}: {dropped} of {T * k} pairs dropped")


@pytest.mark.parametrize("arch", SMOKES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_and_aux_loss_match(arch, dtype):
    cfg = _cfg(arch, dtype)
    jp, tp = _params(cfg)
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model))
    jx = jnp.asarray(x, dtype)
    jy, jaux = jax.jit(lambda p, x: JMoE.moe_apply(p, x, cfg))(jp, jx)
    ty, taux = TMoE.moe_apply(tp, _t(jx), cfg)
    assert ty.dtype == tp["gate"].dtype and taux.dtype == torch.float32
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    else:
        want = _np(jy)
        np.testing.assert_allclose(_np(ty), want, rtol=2.0**-7,
                                   atol=2.0**-7 * np.abs(want).max())


def test_shared_experts_match():
    """A Llama-4-like smoke: MoE every 2nd layer with one shared expert,
    the dense layers at ``d_ff_dense``; the layer alone and the whole
    model in float32."""
    cfg = _cfg("llama4_maverick_400b_a17b", num_layers=4, moe_every=2,
               moe_shared_experts=1, d_ff_dense=256)
    assert [f for _, f in cfg.layer_plan()] == ["mlp", "moe"] * 2
    jp, tp = _params(cfg)
    assert tp["sh_gate"].shape == (cfg.d_model, cfg.d_ff)
    x = np.random.default_rng(6).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    jy, _ = jax.jit(lambda p, x: JMoE.moe_apply(p, x, cfg))(jp, x)
    ty, _ = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    jm = jax.jit(JM.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tm = params_from_numpy(jax.tree.map(np.asarray, jm), cfg, device="cpu")
    assert tm["layers"][0]["mlp"]["up"].shape == (cfg.d_model, 256)
    assert TM.count_params(cfg) == JM.count_params(cfg)
    assert TM.count_active_params(cfg) == JM.count_active_params(cfg)
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    jh = jax.jit(lambda p, t: JM.forward(p, cfg, t)[0])(jm, jnp.asarray(tok))
    th, _, aux = TM.forward(tm, cfg, torch.from_numpy(tok))
    want = np.asarray(jh)
    np.testing.assert_allclose(th.numpy(), want, rtol=0,
                               atol=5e-5 * np.abs(want).max())


def test_fp8_expert_weights_match():
    cfg = _cfg("kimi_k2_1t_a32b", moe_weight_dtype="float8_e4m3fn")
    jp, tp = _params(cfg)
    wg, _, _ = TMoE._expert_weights(tp, cfg)
    assert wg.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(
        wg.float().numpy(),
        np.asarray(jp["gate"].astype(jnp.float8_e4m3fn).astype(jnp.float32)))
    x = np.random.default_rng(8).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    jy, _ = jax.jit(lambda p, x: JMoE.moe_apply(p, x, cfg))(jp, x)
    ty, _ = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
    want, got = np.asarray(jy), ty.numpy()
    err = np.abs(got - want)
    assert err.max() <= 2.0**-3 * np.abs(want).max()
    assert (err > 1e-5 + 1e-5 * np.abs(want)).mean() <= 0.01
    plain, _ = TMoE.moe_apply(tp, torch.from_numpy(x),
                              dataclasses.replace(cfg, moe_weight_dtype=""))
    assert not torch.equal(plain, ty)         # the cast does round


def test_layer_reads_nothing_on_the_host_at_decode_shape():
    """One token (a decode step): capacity 8, every pair kept, and the
    combine adds a token's choices in expert order (k = 8 here)."""
    cfg = _cfg()
    assert TMoE.capacity(cfg, 1) == 8
    jp, tp = _params(cfg)
    x = np.random.default_rng(9).standard_normal(
        (1, 1, cfg.d_model)).astype(np.float32)
    jy, _ = jax.jit(lambda p, x: JMoE.moe_apply(p, x, cfg))(jp, x)
    ty, _ = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    assert int(TMoE.dropped(cfg, torch.from_numpy(x), tp)) == 0
