"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, with the reference's weights carried across by
``params_from_numpy`` and the same numpy inputs given to both.

Layer by layer and whole models (forward, prefill_step, decode_step) on
the smoke configs of qwen3_0_6b (qk-norm) and smollm_360m, in float32,
where the point is the algorithm, and in bfloat16, the models' own type.

Tolerances, with their reasons:

- float32 layers: 1e-5 relative and absolute: one library's matmul and
  rsqrt against the other's, a few float32 ulps;
- float32 models: 5e-5 of the output's largest magnitude: those ulps,
  carried through 4 layers of residual stream;
- bfloat16 layers: one bf16 ulp (2^-7 relative, 2^-7 of the output's
  largest magnitude absolute): both sides compute in float32 and round to
  8 significant bits once, so a result near a rounding boundary may land
  on either neighbour;
- bfloat16 models: 2^-4 of the logits' largest magnitude at any element
  and 2^-7 on average: the libraries round each layer's activations at
  other places (matmul accumulation order, fused element-wise ops), and
  the one-ulp differences pass through 4 layers.

Neither side uses TF32: these are CPU runs, and the port's ``forward``
keeps float32 products in full float32 on the card
(``utils.device.full_precision_matmul``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

# One intra-op thread: the suite runs several workers on the machine's
# cores, and a full torch thread pool in each of them oversubscribes the
# cores and slows the small ops here by two orders of magnitude.
torch.set_num_threads(1)

ARCHS = ["qwen3_0_6b", "smollm_360m"]
LAYER_F32 = dict(rtol=1e-5, atol=1e-5)


def _np(a) -> np.ndarray:
    """A JAX array or tensor as a float32 (or integer) numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind in "fV" or \
        a.dtype.name == "bfloat16" else a


def _close_layer(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **LAYER_F32)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=2.0**-7,
                                   atol=2.0**-7 * scale)


def _close_model(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        assert err.max() <= 5e-5 * scale, f"{what}: {err.max()} of {scale}"
    else:
        assert err.max() <= 2.0**-4 * scale, f"{what}: {err.max()} of {scale}"
        assert err.mean() <= 2.0**-7 * scale, f"{what}: mean {err.mean()}"


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str):
    """The reference's smoke model at ``dtype`` (params, numpy params) and
    the port's parameters carried from it. The reference draws every leaf
    in float32 and casts it to the model's dtype, so the bfloat16 model is
    the float32 draw cast (one compiled init per architecture)."""
    cfg = dataclasses.replace(j_get_arch(arch, smoke=True), dtype=dtype)
    if dtype == "float32":
        jp = jax.jit(JM.init_params, static_argnums=0)(cfg,
                                                       jax.random.PRNGKey(0))
    else:
        jp = jax.tree.map(lambda a: a.astype(dtype),
                          _models(arch, "float32")[1])
    npp = jax.tree.map(np.asarray, jp)
    return cfg, jp, npp, params_from_numpy(npp, cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(cfg):
    """The reference's forward / prefill / cached forward / decode step,
    each compiled once for ``cfg`` (eager JAX re-traces the layer scan on
    every call)."""
    def cached_forward(p, tok, caches):
        return JM.forward(p, cfg, tok, caches=caches,
                          cache_len=jnp.zeros((), jnp.int32))[1]

    return (jax.jit(lambda p, tok: JM.forward(p, cfg, tok)[0]),
            jax.jit(lambda p, tok: JM.prefill_step(p, cfg, tok)),
            jax.jit(cached_forward),
            jax.jit(lambda p, c, n, tok: JM.decode_step(p, cfg, c, n, tok)))


def _shapes(tree, path=""):
    """{path: (shape, dtype)} of a tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), tree.dtype)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out |= _shapes(v, f"{path}/{k}")
    return out


def _tokens(cfg, B=2, S=24, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(arch, smoke):
    assert dataclasses.asdict(get_arch(arch, smoke)) == \
        dataclasses.asdict(j_get_arch(arch, smoke))
    assert dataclasses.asdict(get_arch(arch.replace("_", "-"), smoke)) == \
        dataclasses.asdict(j_get_arch(arch, smoke))


def test_unported_archs_raise():
    assert list_archs() == ["smollm_360m", "qwen3_0_6b"]
    for name in ("jamba_v0_1_52b", "rwkv6_1_6b", "kimi_k2_1t_a32b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_arch(name)
    for pattern in ("mamba", "rwkv", "jamba"):
        cfg = dataclasses.replace(get_arch("smollm_360m", smoke=True),
                                  layer_pattern=pattern)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TM.init_params(cfg, 0, device="cpu")
    moe = dataclasses.replace(get_arch("smollm_360m", smoke=True),
                              moe_num_experts=4, moe_top_k=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.stack_cache_init(moe, 1, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference(arch):
    for smoke in (False, True):
        cfg = j_get_arch(arch, smoke)
        assert TM.count_params(cfg) == JM.count_params(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_mirrors_the_reference_tree(dtype):
    """Same structure, shapes and dtypes as the carried reference tree;
    the reference's std formulas; one seed, one draw."""
    cfg, _, _, carried = _models("qwen3_0_6b", dtype)
    mine = TM.init_params(cfg, 3, device="cpu")
    assert _shapes(mine) == _shapes(carried)
    w = mine["layers"][1]["mlp"]["down"].float()
    assert abs(float(w.std()) * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert float(mine["layers"][0]["attn"]["q_norm"].float().min()) == 1.0
    again = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y)
               for x, y in zip(TM.leaves(mine), TM.leaves(again)))


def test_params_from_numpy_is_a_copy_by_layer():
    """Layer li of the port is slice li of the reference's stacked
    leaves, bit for bit, in the (in, out) layout and dtype."""
    cfg, _, npp, carried = _models("qwen3_0_6b", "bfloat16")
    for li in range(cfg.num_layers):
        for part in ("attn", "mlp", "norm1"):
            for name, leaf in npp["layers"][0][part].items():
                t = carried["layers"][li][part][name]
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(_np(t), _np(leaf[li]))
    np.testing.assert_array_equal(_np(carried["head"]["w"]),
                                  _np(npp["head"]["w"]))
    f = tensor_from_numpy(np.arange(6, dtype=np.float32), "cpu")
    assert f.dtype == torch.float32 and f.tolist() == list(range(6))


# ---------------------------------------------------------------------------
# layer by layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_qkv_mlp_match(dtype):
    cfg, jp, npp, tp = _models("qwen3_0_6b", dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, cfg.dtype)
    tx = tensor_from_numpy(np.asarray(jx), "cpu")
    scale = npp["layers"][0]["norm1"]["scale"][0] * 1.5
    _close_layer(TL.rms_norm(tx, tensor_from_numpy(scale, "cpu"),
                             cfg.norm_eps),
                 JL.rms_norm(jx, jnp.asarray(scale), cfg.norm_eps), dtype)
    pos = np.tile(np.arange(3, 13, dtype=np.int32), (2, 1))
    h4 = jx.reshape(2, 10, 8, 16)
    _close_layer(TL.rope(tx.reshape(2, 10, 8, 16), torch.from_numpy(pos),
                         cfg.rope_theta),
                 JL.rope(h4, jnp.asarray(pos), cfg.rope_theta), dtype)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"][0]["attn"])
    for got, want in zip(
            TL.attn_qkv(tp["layers"][0]["attn"], tx, cfg,
                        positions=torch.from_numpy(pos)),
            JL.attn_qkv(jattn, jx, cfg, positions=jnp.asarray(pos))):
        _close_layer(got, want, dtype)
    jmlp = jax.tree.map(lambda a: a[0], jp["layers"][0]["mlp"])
    _close_layer(TL.mlp_apply(tp["layers"][0]["mlp"], tx),
                 JL.mlp_apply(jmlp, jx), dtype)
    gelu = dataclasses.replace(cfg, mlp_variant="gelu")
    gp = JL.mlp_init(jax.random.PRNGKey(5), gelu)
    _close_layer(TL.mlp_apply({k: tensor_from_numpy(np.asarray(v), "cpu")
                               for k, v in gp.items()}, tx),
                 JL.mlp_apply(gp, jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_apply_both_branches_match(dtype):
    """No cache (training form) and cache (prefill into an empty cache,
    then a decode step), against the reference's branches."""
    cfg, jp, _, tp = _models("smollm_360m", dtype)
    rng = np.random.default_rng(2)
    B, S, Smax = 2, 9, 12
    x = jnp.asarray(rng.standard_normal((B, S + 1, cfg.d_model)), cfg.dtype)
    tx = tensor_from_numpy(np.asarray(x), "cpu")
    jpa = jax.tree.map(lambda a: a[1], jp["layers"][0]["attn"])
    j_attn = jax.jit(JL.attn_apply, static_argnums=2,
                     static_argnames="return_kv")
    tpa = tp["layers"][1]["attn"]
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jy, jkv = j_attn(jpa, x[:, :S], cfg, positions=jnp.asarray(pos),
                     return_kv=True)
    ty, tkv = TL.attn_apply(tpa, tx[:, :S], cfg,
                            positions=torch.from_numpy(pos), return_kv=True)
    _close_layer(ty, jy, dtype)
    _close_layer(tkv["k"], jkv["k"], dtype)
    jc = JL.attn_cache_init(cfg, B, Smax)
    tc = TL.attn_cache_init(cfg, B, Smax)
    jy, jc = j_attn(jpa, x[:, :S], cfg, positions=jnp.asarray(pos), cache=jc,
                    cache_len=jnp.asarray(0, jnp.int32))
    ty, tc = TL.attn_apply(tpa, tx[:, :S], cfg,
                           positions=torch.from_numpy(pos), cache=tc,
                           cache_len=0)
    _close_layer(ty, jy, dtype)
    _close_layer(tc["v"], jc["v"], dtype)
    dpos = np.full((B, 1), S, np.int32)
    jy, jc = j_attn(jpa, x[:, S:], cfg, positions=jnp.asarray(dpos), cache=jc,
                    cache_len=jnp.asarray(S, jnp.int32))
    ty, tc = TL.attn_apply(tpa, tx[:, S:], cfg,
                           positions=torch.from_numpy(dpos), cache=tc,
                           cache_len=S)
    _close_layer(ty, jy, dtype)
    _close_layer(tc["k"], jc["k"], dtype)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_logits_match(arch, dtype):
    cfg, jp, _, tp = _models(arch, dtype)
    tok = _tokens(cfg)
    B, S = tok.shape
    P = S - 3
    j_forward, j_prefill, j_cached, j_decode = _jitted(cfg)
    jx = j_forward(jp, jnp.asarray(tok))
    tx, _, _ = TM.forward(tp, cfg, torch.from_numpy(tok))
    _close_model(tx, jx, dtype, "forward hidden")
    jl, jc = j_prefill(jp, jnp.asarray(tok[:, :P]))
    tl, tc = TM.prefill_step(tp, cfg, torch.from_numpy(tok[:, :P]))
    _close_model(tl, jl, dtype, "prefill logits")
    for li in range(cfg.num_layers):
        _close_model(tc[li]["k"], jc[0]["k"][li], dtype, f"cache k {li}")
    jcaches = JT.stack_cache_init(cfg, B, S)
    tcaches = TT.stack_cache_init(cfg, B, S)
    jcaches = j_cached(jp, jnp.asarray(tok[:, :P]), jcaches)
    _, tcaches, _ = TM.forward(tp, cfg, torch.from_numpy(tok[:, :P]),
                               caches=tcaches, cache_len=0)
    for t in range(P, S):
        jl, jcaches = j_decode(jp, jcaches, jnp.asarray(t, jnp.int32),
                               jnp.asarray(tok[:, t:t + 1]))
        tl, tcaches = TM.decode_step(tp, cfg, tcaches, t,
                                     torch.from_numpy(tok[:, t:t + 1]))
        assert tl.dtype == torch.float32 and tl.shape == (B, cfg.padded_vocab)
        _close_model(tl, jl, dtype, f"decode logits at {t}")


def test_stack_apply_hands_the_override_its_global_layer():
    cfg, _, _, tp = _models("qwen3_0_6b", "float32")
    seen = []

    def override(layer, p, h, *, positions, cache, cache_len):
        seen.append(layer)
        return TL.attn_apply(p, h, cfg, positions=positions, cache=cache,
                             cache_len=cache_len)

    tok = torch.from_numpy(_tokens(cfg, B=1, S=6))
    caches = TT.stack_cache_init(cfg, 1, 8)
    plain, _, _ = TM.forward(tp, cfg, tok, caches=caches, cache_len=0)
    caches = TT.stack_cache_init(cfg, 1, 8)
    x, _, _ = TM.forward(tp, cfg, tok, caches=caches, cache_len=0,
                         attn_override=override)
    assert seen == list(range(cfg.num_layers))
    assert torch.equal(x, plain)
