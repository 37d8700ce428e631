"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, with the reference's weights carried across by
``params_from_numpy`` and the same numpy inputs given to both.

Layer by layer and whole models (forward, prefill_step, decode_step) on
the smoke configs of all ten architectures (attention, Mamba and RWKV6
mixers; MLP and MoE feed-forwards; token and stub-frontend inputs), in
float32, where the point is the algorithm, and in bfloat16, the models'
own type. The MoE, Mamba and RWKV6 blocks alone are held in
``test_torch_moe.py``, ``test_torch_ssm.py`` and ``test_torch_rwkv6.py``.

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

MoE routes: a float32 model's expert choices must equal the reference's
token by token. A bfloat16 model runs on the reference's recorded
choices (``_torch_parity.MoERoutes``), and a choice of its own that
differs must be a near tie: expert choice is discrete, and a one-ulp
difference upstream flips a route now and then, after which that token
leaves any tolerance.

Neither side uses TF32: these are CPU runs, and the port's ``forward``
keeps float32 products in full float32 on the card
(``utils.device.full_precision_matmul``).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import MoERoutes
from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
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

ARCHS = j_list_archs()
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


def _close_model(got, want, dtype, what, truth=None):
    """The model tolerances of the module docstring; with ``truth`` (the
    float32 computation of a bf16 model) each bf16 bound is at least
    twice the reference's own error against it."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        assert err.max() <= 5e-5 * scale, f"{what}: {err.max()} of {scale}"
    else:
        top, mean = 2.0**-4 * scale, 2.0**-7 * scale
        if truth is not None:
            own = np.abs(want - _np(truth))
            top, mean = max(top, 2 * own.max()), max(mean, 2 * own.mean())
        assert err.max() <= top, f"{what}: {err.max()} of {scale}"
        assert err.mean() <= mean, f"{what}: mean {err.mean()} of {scale}"


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str):
    """The reference's smoke model at ``dtype`` (params, numpy params) and
    the port's parameters carried from it. The reference draws every leaf
    in float32 and casts it to its dtype (float32 leaves such as the MoE
    router and the SSM and RWKV decays stay float32), so the bfloat16
    model is the float32 draw cast leaf by leaf to the reference's
    bfloat16 tree (one compiled init per architecture)."""
    cfg = dataclasses.replace(j_get_arch(arch, smoke=True), dtype=dtype)
    if dtype == "float32":
        jp = jax.jit(JM.init_params, static_argnums=0)(cfg,
                                                       jax.random.PRNGKey(0))
    else:
        want = jax.eval_shape(lambda k: JM.init_params(cfg, k),
                              jax.random.PRNGKey(0))
        jp = jax.tree.map(lambda a, w: a.astype(w.dtype),
                          _models(arch, "float32")[1], want)
    npp = jax.tree.map(np.asarray, jp)
    return cfg, jp, npp, params_from_numpy(npp, cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(cfg):
    """The reference's forward / prefill / cached forward / decode step,
    each compiled once for ``cfg`` (eager JAX re-traces the layer scan on
    every call), and the ``MoERoutes`` they record into (MoE configs)."""
    def cached_forward(p, tok, caches):
        return JM.forward(p, cfg, tok, caches=caches,
                          cache_len=jnp.zeros((), jnp.int32))[1]

    fns = (jax.jit(lambda p, tok: JM.forward(p, cfg, tok)[0]),
           jax.jit(lambda p, tok: JM.prefill_step(p, cfg, tok)),
           jax.jit(cached_forward),
           jax.jit(lambda p, c, n, tok: JM.decode_step(p, cfg, c, n, tok)))
    routes = MoERoutes()
    if cfg.moe_num_experts:
        fns = tuple(routes.reference(fn) for fn in fns)
    return fns + (routes,)


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
    """Token ids, or for a stub frontend (vlm / audio) float32 embeddings
    (B, S, d_model) in their place."""
    rng = np.random.default_rng(seed)
    if cfg.frontend is not None:
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _cache_leaves(tc, jc, cfg):
    """(name, port leaf, reference leaf) of every layer's cache: layer li
    of the port is slice li // period of the reference's period position
    li % period."""
    period = cfg.period()
    for li in range(cfg.num_layers):
        for name, leaf in tc[li].items():
            yield f"cache {name} {li}", leaf, \
                jc[li % period][name][li // period]


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


def test_list_archs_is_the_reference_order():
    assert list_archs() == j_list_archs()
    with pytest.raises(ValueError, match="unknown architecture"):
        get_arch("gpt2")


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference(arch):
    """Total and active parameters, at full size (the meta device: up to
    Kimi-K2's 1.04T) and smoke size."""
    for smoke in (False, True):
        cfg = j_get_arch(arch, smoke)
        assert TM.count_params(cfg) == JM.count_params(cfg)
        assert TM.count_active_params(cfg) == JM.count_active_params(cfg)
    if arch == "jamba_v0_1_52b":
        one_period = dataclasses.replace(j_get_arch(arch), num_layers=8)
        assert TM.count_params(j_get_arch(arch)) == 51_570_315_264
        assert (TM.count_params(one_period),
                TM.count_active_params(one_period)) == (13_295_235_072,
                                                        3_430_232_064)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_mirrors_the_reference_tree_all_archs(arch):
    """The port's own draw has the carried reference tree's structure,
    shapes and dtypes at the model's bfloat16."""
    cfg, _, _, carried = _models(arch, "bfloat16")
    mine = TM.init_params(cfg, 1, device="cpu")
    assert _shapes(mine) == _shapes(carried)


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
    # a period of 8 (Jamba: attention at position 4, MoE at odd ones):
    # layer li is slice li // 8 of position li % 8; float32 leaves stay so
    cfg, _, npp, carried = _models("jamba_v0_1_52b", "bfloat16")
    plan = cfg.layer_plan()
    for li, (mix, ffn) in enumerate(plan):
        for part in (mix, ffn):
            for name, leaf in npp["layers"][li % 8][part].items():
                t = carried["layers"][li][part][name]
                assert str(t.dtype)[6:] == leaf.dtype.name, (li, part, name)
                np.testing.assert_array_equal(_np(t), _np(leaf[li // 8]))
    assert carried["layers"][3]["moe"]["router"].dtype == torch.float32
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

def _recurrent(cfg) -> bool:
    return cfg.layer_pattern in ("mamba", "rwkv", "jamba")


def _close_caches(caches, jc, cfg, close, prefix):
    """``close`` on every cache leaf: ``caches`` maps a side to its
    per-layer caches, ``jc`` the reference's."""
    per_side = {side: list(_cache_leaves(c, jc, cfg))
                for side, c in caches.items()}
    for i, (what, _, want) in enumerate(per_side["port"]):
        close({side: leaves[i][1] for side, leaves in per_side.items()},
              want, prefix + what)


@functools.lru_cache(maxsize=None)
def _truth(arch: str):
    """The port's float32 model on the bfloat16 model's weights (each
    bf16 leaf widened exactly): the float32 computation a bf16 model
    approximates. The float32 tests hold the port's float32 models to the
    reference's within 5e-5, so this stands for the reference's too."""
    cfg, _, npp, _ = _models(arch, "bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    wide = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), npp)
    return cfg32, params_from_numpy(wide, cfg32, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_logits_match(arch, dtype):
    """Hidden states, prefill logits, every layer's cache (K/V, Mamba
    and RWKV states) and decode logits, the MoE routes held as the module
    docstring says. A bfloat16 model with a recurrent mixer (Mamba,
    RWKV6) is also run as its float32 computation (``_truth``), and each
    tolerance is at least twice the reference's own bf16 error against
    it: the recurrent state carries every earlier position's rounding
    forward, so the reference itself drifts from its float32 computation
    by more than the attention stacks' 4-layer tolerance (RWKV6 smoke:
    0.0073 of the scale on average at layer 3's shift state), and two
    independent roundings of that size differ by up to twice it."""
    cfg, jp, _, tp = _models(arch, dtype)
    sides = {"port": (cfg, tp)}
    if dtype == "bfloat16" and _recurrent(cfg):
        sides["truth"] = _truth(arch)
    tok = _tokens(cfg)
    B, S = tok.shape[:2]
    P = S - 3
    j_forward, j_prefill, j_cached, j_decode, routes = _jitted(cfg)
    ported = routes.port(inject=dtype != "float32") if cfg.moe_num_experts \
        else contextlib.nullcontext()

    def both(fn):
        """``fn(cfg, params, side)`` on the port's model and, when
        present, on the truth, each fed the same recorded MoE routes."""
        first = routes.next
        out = {}
        for side, (c, p) in sides.items():
            routes.next = first
            out[side] = fn(c, p, side)
        return out

    def close(got, want, what):
        _close_model(got["port"], want, dtype, what, got.get("truth"))

    tt = torch.from_numpy(tok)
    with ported:
        jx = j_forward(jp, jnp.asarray(tok))
        close(both(lambda c, p, _: TM.forward(p, c, tt)[0]), jx,
              "forward hidden")
        jl, jc = j_prefill(jp, jnp.asarray(tok[:, :P]))
        pre = both(lambda c, p, _: TM.prefill_step(p, c, tt[:, :P]))
        close({k: v[0] for k, v in pre.items()}, jl, "prefill logits")
        _close_caches({k: v[1] for k, v in pre.items()}, jc, cfg, close, "")
        jcaches = j_cached(jp, jnp.asarray(tok[:, :P]),
                           JT.stack_cache_init(cfg, B, S))
        tcaches = {side: TT.stack_cache_init(c, B, S)
                   for side, (c, _) in sides.items()}
        both(lambda c, p, side: TM.forward(p, c, tt[:, :P],
                                           caches=tcaches[side], cache_len=0))
        for t in range(P, S):
            jl, jcaches = j_decode(jp, jcaches, jnp.asarray(t, jnp.int32),
                                   jnp.asarray(tok[:, t:t + 1]))
            tl = both(lambda c, p, side: TM.decode_step(
                p, c, tcaches[side], t, tt[:, t:t + 1])[0])
            assert tl["port"].dtype == torch.float32 and \
                tl["port"].shape == (B, cfg.padded_vocab)
            close(tl, jl, f"decode logits at {t}")
        _close_caches(tcaches, jcaches, cfg, close, "after decode, ")
    if routes.flips:
        print(f"{arch}: {len(routes.flips)} near-tie routes, gaps "
              f"{routes.flips}")


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
    # a hybrid plan hands the override its attention layers only
    cfg, _, _, tp = _models("jamba_v0_1_52b", "float32")
    seen.clear()
    caches = TT.stack_cache_init(cfg, 1, 8)
    plain, _, _ = TM.forward(tp, cfg, tok, caches=caches, cache_len=0)
    caches = TT.stack_cache_init(cfg, 1, 8)
    x, _, _ = TM.forward(tp, cfg, tok, caches=caches, cache_len=0,
                         attn_override=override)
    assert seen == [4] and torch.equal(x, plain)
