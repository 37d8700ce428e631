"""The port's training slice against the reference: the loss
(``models.train_loss``, ``layers.chunked_cross_entropy``) and its
gradients, remat, the train step (``launch.steps.make_train_step``), the
trainer (``launch.train``, both modes, checkpoint and resume) and the
serving launcher (``launch.serve``).

The reference's weights are carried into the port by
``params_from_numpy`` and the port's gradients and states carried back by
``params_to_numpy``; inputs are numpy from a seed. MoE routes: float32
models must choose the reference's experts token by token; bf16 models
run on the reference's recorded choices (``_torch_parity.MoERoutes``),
near ties counted. MoE configs run with ``remat`` off on both sides (the
recorded routes are one per MoE call; a remat'd layer routes again in the
backward pass); remat itself is held to no-remat bit for bit. RWKV6 runs
its step recurrence at these lengths (S < 128) in both packages, short of
the reference's chunked clamp (ROADMAP.md, Queue 3).

Tolerances, with their reasons:

- float32 loss: 1e-6 relative (observed ≤ 1.5e-7: the libraries' sums
  round differently); float32 gradients: 5e-5 of each leaf's largest
  magnitude (observed ≤ 1.5e-5, RWKV6): those ulps through the forward and
  backward of 4 layers;
- bf16 loss and gradients: within 3 times the reference's own error
  against the float32 computation on the same weights (the port's float32
  model on the widened bf16 leaves, which the float32 tests hold to the
  reference's) at any element, 2 times on average, at least one bf16 ulp
  of the leaf's scale: two independent bf16 computations each that far
  from the float32 one may differ by twice it, and the largest element
  error of each lands on other elements (observed ratios ≤ 2.3 and 1.4);
- train steps (AdamW): metrics within 5e-6 relative; parameters within
  1e-3 lr on average, and no more than 1e-3 of the elements more than
  lr / 100 apart, each of those within two steps' size a step. AdamW's
  step ``lr · (m̂ / (√v̂ + eps) + wd · p)`` is at most about
  ``lr · (1 + wd · |p|)`` in size, and where a gradient
  is as small as ``eps`` (1e-8), far below the gradients' tolerance, the
  two packages' steps there may differ by up to both their sizes
  (observed: up to 0.52 lr at ~2e-4 of the elements, 1.3e-5 lr on
  average); the moments within 2e-4 of each leaf's scale (the gradients'
  tolerance, carried);
- the int8-compressed DDP step: losses and parameters as train steps;
  the moments within 2e-4 of each leaf's scale and the error-feedback
  residuals within 2e-3 of each leaf's quantization step (``max |g| /
  127``, twice the largest residual; the step itself moves with the
  gradients' largest element, and a residual of up to 127 steps' worth
  of it with it), except where a rounding to int8 flips by one level
  (an element at a half step): that moves the element's mean gradient by
  one level at each of the step's two roundings, its moments by up to 4
  levels of their scale a step (4/127: two roundings, and a moment's
  scale may be under half the gradient's when its signs change between
  steps; observed ≤ 0.0075 here, 0.033 card against CPU) and its
  residual by one step. Those are counted and must be rare (≤ 1e-4 of
  the elements; observed ~3e-5).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_dist
from _torch_parity import MoERoutes
from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.distributed.compression import compressed_psum_tree as j_cpsum
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTRAIN
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        to_reference_layout)
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ARCHS = j_list_archs()
LR = 1e-3
B, S = 2, 32


def _np(a) -> np.ndarray:
    """Any leaf as float32 (or integer) numpy; ``V2`` words as bf16."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    if a.dtype == np.dtype("V2"):
        a = a.view(ml_dtypes.bfloat16)
    return a.astype(np.float32) if a.dtype.kind == "f" or \
        a.dtype.name == "bfloat16" else a


def _cfgs(arch: str, dtype: str):
    """(reference config, port config) of the smoke model at ``dtype``,
    remat off for MoE configs (module docstring)."""
    jcfg = dataclasses.replace(j_get_arch(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype=dtype)
    if jcfg.moe_num_experts:
        jcfg = dataclasses.replace(jcfg, remat=False)
        cfg = dataclasses.replace(cfg, remat=False)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str):
    """The reference's smoke parameters at ``dtype`` (drawn in float32,
    cast leaf by leaf to the reference's tree), as JAX arrays and numpy,
    and the port's carried from them."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = JM.init_params(dataclasses.replace(jcfg, dtype="float32"),
                        jax.random.PRNGKey(0))
    want = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a, w: a.astype(w.dtype), jp, want)
    npp = jax.tree.map(np.asarray, jp)
    return jcfg, cfg, jp, npp, params_from_numpy(npp, cfg, device="cpu")


def _batch(cfg, seed: int = 0, batch: int = B, seq: int = S):
    """Token ids (or float32 embeddings for stub frontends) and labels."""
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        inputs = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    else:
        inputs = rng.standard_normal((batch, seq, cfg.d_model)
                                     ).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_close(got_tree, want_tree, rel, what, mean_rel=None):
    """Leaf by leaf (the reference's layout): max |Δ| ≤ rel · the leaf's
    largest magnitude (and the mean ≤ mean_rel · it)."""
    for i, (g, w) in enumerate(zip(jax.tree.leaves(got_tree),
                                   jax.tree.leaves(want_tree))):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, f"{what} leaf {i}"
        scale = float(np.abs(w).max())
        err = np.abs(g - w)
        assert err.max() <= rel * scale, f"{what} leaf {i}: {err.max()} " \
                                         f"of {scale}"
        if mean_rel is not None:
            assert err.mean() <= mean_rel * scale, f"{what} leaf {i} mean"


def _adamw_close(got_tree, want_tree, steps: int, what: str, wd=0.1):
    """AdamW's parameters after ``steps`` steps (module docstring)."""
    far = total = 0
    for i, (g, w) in enumerate(zip(jax.tree.leaves(got_tree),
                                   jax.tree.leaves(want_tree))):
        w = _np(w)
        err = np.abs(_np(g) - w)
        step_size = LR * (1 + wd * float(np.abs(w).max()))
        assert err.max() <= 2 * steps * step_size, f"{what} leaf {i}"
        assert err.mean() <= 1e-3 * LR, f"{what} leaf {i} mean"
        far += int((err > LR / 100).sum())
        total += err.size
    assert far <= 1e-3 * total, f"{what}: {far} of {total} elements"


def _routes_ctx(routes, cfg, inject):
    return routes.port(inject=inject) if cfg.moe_num_experts \
        else contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def _j_loss_grad(jcfg):
    fn = jax.jit(jax.value_and_grad(lambda p, b: JM.train_loss(p, jcfg, b),
                                    has_aux=True))
    routes = MoERoutes()
    return (routes.reference(fn) if jcfg.moe_num_experts else fn), routes


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_the_reference(arch):
    """float32: the loss, its parts and every parameter's gradient."""
    jcfg, cfg, jp, _, tp = _models(arch, "float32")
    batch = _batch(cfg)
    fn, routes = _j_loss_grad(jcfg)
    (jl, jparts), jg = fn(jp, jax.tree.map(jnp.asarray, batch))
    with _routes_ctx(routes, cfg, inject=False):
        tl, tparts, tg = TS.loss_and_grads(cfg, tp, _torch_batch(batch))
    assert tl.dtype == torch.float32 and tl.shape == ()
    for got, want in ((tl, jl), (tparts["ce"], jparts["ce"]),
                      (tparts["aux"], jparts["aux"])):
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    if cfg.moe_num_experts:
        assert float(tparts["aux"]) > 0
    for g, p in zip(tree_leaves(tg), tree_leaves(tp)):
        assert g.dtype == p.dtype == torch.float32
    _leaves_close(params_to_numpy(tg, cfg), jg, 5e-5, f"{arch} grads")


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "jamba_v0_1_52b"])
def test_train_loss_and_grads_bf16_match_the_reference(arch):
    """bf16 models, the reference's MoE routes fed to the port: the loss
    and gradients within the module docstring's bound against the
    reference's own error from the float32 computation."""
    jcfg, cfg, jp, npp, tp = _models(arch, "bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    wide = params_from_numpy(jax.tree.map(
        lambda a: np.asarray(a).astype(np.float32), npp), cfg32, device="cpu")
    batch = _batch(cfg)
    fn, routes = _j_loss_grad(jcfg)
    (jl, _), jg = fn(jp, jax.tree.map(jnp.asarray, batch))
    with _routes_ctx(routes, cfg, inject=True):
        tl, _, tg = TS.loss_and_grads(cfg, tp, _torch_batch(batch))
        routes.next = 0
        ul, _, ug = TS.loss_and_grads(cfg32, wide, _torch_batch(batch))
    assert abs(float(tl) - float(jl)) <= 3 * abs(float(jl) - float(ul)) + 1e-6
    for g, p in zip(tree_leaves(tg), tree_leaves(tp)):
        assert g.dtype == p.dtype
    for i, (g, w, u) in enumerate(zip(
            jax.tree.leaves(params_to_numpy(tg, cfg)), jax.tree.leaves(jg),
            jax.tree.leaves(params_to_numpy(ug, cfg32)))):
        g, w, u = _np(g), _np(w), _np(u)
        base = 2.0 ** -8 * float(np.abs(w).max())
        own, err = np.abs(w - u), np.abs(g - w)
        assert err.max() <= max(3 * own.max(), base), f"{arch} leaf {i}"
        assert err.mean() <= max(2 * own.mean(), base), f"{arch} leaf {i}"
    if routes.flips:
        print(f"{arch}: {len(routes.flips)} near-tie routes")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients_bit_for_bit(arch):
    """``cfg.remat`` recomputes each period in the backward pass (each
    block runs twice) and changes no bit of the loss or the gradients."""
    cfg = get_arch(arch, smoke=True)
    tp = TM.init_params(cfg, 1, device="cpu")
    batch = _torch_batch(_batch(cfg, seed=3))
    calls = []
    real = TT.block_apply

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    out = {}
    for remat in (True, False):
        calls.clear()
        TT.block_apply = counting
        try:
            out[remat] = TS.loss_and_grads(
                dataclasses.replace(cfg, remat=remat), tp, batch)
        finally:
            TT.block_apply = real
        assert len(calls) == cfg.num_layers * (2 if remat else 1)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seq", [8, 5, 24])
def test_chunked_cross_entropy_matches_the_reference(seq):
    """S = chunk, S < chunk (one chunk of S), S = 3 chunks: the value and
    its gradients in x and the head, float32 within 1e-6 relative."""
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    lab = rng.integers(0, 40, (2, seq)).astype(np.int32)
    jv, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: JL.chunked_cross_entropy(a, b, jnp.asarray(lab),
                                              chunk=8), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tv = TL.chunked_cross_entropy(tx, tw, torch.from_numpy(lab), chunk=8)
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-6)
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))
    with torch.no_grad():
        assert float(TL.chunked_cross_entropy(tx, tw, torch.from_numpy(lab),
                                              chunk=8)) == float(tv)


def test_chunked_cross_entropy_refuses_a_ragged_split():
    """S = 17 is two chunks of 8 and one token over: the reference's
    reshape fails, and the port raises rather than drop the token."""
    x = np.zeros((1, 17, 4), np.float32)
    w = np.zeros((4, 6), np.float32)
    lab = np.zeros((1, 17), np.int32)
    with pytest.raises((TypeError, ValueError)):
        JL.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(lab), chunk=8)
    with pytest.raises(ValueError, match="17"):
        TL.chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(lab), chunk=8)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "kimi_k2_1t_a32b"])
def test_train_step_matches_the_reference(arch, grad_accum):
    """Two AdamW steps (warmup-cosine) of the float32 smoke model on
    batches of 4: metrics, parameters and moments (module docstring); in
    accumulation mode ``aux`` is reported as 0 and ``ce`` as the loss."""
    jcfg, cfg, jp, _, tp = _models(arch, "float32")
    rng = np.random.default_rng(1)
    batches = [_batch(cfg, seed=int(rng.integers(1 << 30)), batch=4)
               for _ in range(2)]
    jo, to = j_adamw(j_warmup_cosine(LR, 1, 4)), adamw(warmup_cosine(LR, 1, 4))
    routes = MoERoutes()
    jf = jax.jit(JS.make_train_step(jcfg, jo, grad_accum=grad_accum))
    if cfg.moe_num_experts:
        jf = routes.reference(jf)
    tf = TS.make_train_step(cfg, to, grad_accum=grad_accum)
    js, ts = jo.init(jp), to.init(tp)
    for s, b in enumerate(batches):
        jp, js, jstep, jm = jf(jp, js, jnp.int32(s),
                               jax.tree.map(jnp.asarray, b))
        with _routes_ctx(routes, cfg, inject=False):
            tp, ts, tstep, tm = tf(tp, ts, s, _torch_batch(b))
        assert tstep == int(jstep) == s + 1
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=5e-6,
                                                 abs=1e-7), k
        if grad_accum > 1:
            assert float(tm["aux"]) == 0.0 and float(tm["ce"]) == \
                float(tm["loss"])
    _adamw_close(params_to_numpy(tp, cfg), jp, 2, f"{arch} params")
    for part in ("mu", "nu"):
        _leaves_close(params_to_numpy(ts[part], cfg), js[part], 2e-4, part)


def test_abstract_inputs_and_shapes_mirror_the_reference():
    """``SHAPES``, ``shape_applicable``, the meta-device parameters,
    caches and batch shapes against the reference's ShapeDtypeStructs;
    the prefill and decode step factories are the model's steps."""
    assert {k: dataclasses.astuple(v) for k, v in TS.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JS.SHAPES.items()}
    for arch in ARCHS:
        jcfg, cfg = j_get_arch(arch), get_arch(arch)
        for shape in TS.SHAPES:
            assert TS.shape_applicable(cfg, shape) == \
                JS.shape_applicable(jcfg, shape)
    jcfg, cfg = j_get_arch("jamba_v0_1_52b"), get_arch("jamba_v0_1_52b")
    ap = TS.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(ap))
    def desc(shape, dtype):
        return tuple(shape), str(dtype).replace("torch.", "")

    got = to_reference_layout(
        ap, cfg, lambda ts: desc((len(ts),) + tuple(ts[0].shape),
                                 ts[0].dtype),
        lambda t: desc(t.shape, t.dtype))
    assert got == jax.tree.map(lambda a: desc(a.shape, a.dtype),
                               JS.abstract_params(jcfg))
    caches = TS.abstract_caches(cfg, 2, 64)
    jc = JS.abstract_caches(jcfg, 2, 64)
    period = cfg.period()
    for li, c in enumerate(caches):
        for name, t in c.items():
            want = jc[li % period][name]
            assert t.device.type == "meta"
            assert (len(caches) // period,) + tuple(t.shape) == want.shape
    for arch in ("qwen3_0_6b", "internvl2_1b"):
        jcfg, cfg = j_get_arch(arch), get_arch(arch)
        case = TS.SHAPES["train_4k"]
        jb, jspecs = JS.batch_specs(jcfg, JS.SHAPES["train_4k"])
        tb, tspecs = TS.batch_specs(cfg, case)
        for k in ("inputs", "labels"):
            assert tuple(tb[k].shape) == jb[k].shape
            assert str(tb[k].dtype).replace("torch.", "") == str(jb[k].dtype)
            assert tspecs[k] == tuple(jspecs[k])
        jt, jspec = JS.token_specs(jcfg, 8)
        tt, tspec = TS.token_specs(cfg, 8)
        assert tuple(tt.shape) == jt.shape
        assert str(tt.dtype).replace("torch.", "") == str(jt.dtype)
        assert tspec == tuple(jspec)
    _, cfg, _, _, tp = _models("qwen3_0_6b", "float32")
    tok = torch.from_numpy(_batch(cfg)["inputs"])
    lg, caches = TS.make_prefill_step(cfg)(tp, tok)
    want, _ = TM.prefill_step(tp, cfg, tok)
    assert torch.equal(lg, want)
    full = TT.stack_cache_init(cfg, B, S + 1)
    TM.forward(tp, cfg, tok, caches=full, cache_len=0)
    step = TS.make_decode_step(cfg)(tp, full, S, tok[:, :1])[0]
    full2 = TT.stack_cache_init(cfg, B, S + 1)
    TM.forward(tp, cfg, tok, caches=full2, cache_len=0)
    assert torch.equal(step, TM.decode_step(tp, cfg, full2, S, tok[:, :1])[0])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--device", "cpu", "--arch", "qwen3_0_6b", "--smoke",
              "--steps", "6", "--batch", "4", "--seq", "32", "--lr", "1e-3",
              "--warmup", "2", "--log-every", "1"]


def _train(extra, **kw):
    args = TTRAIN.build_parser().parse_args(TRAIN_ARGS + extra)
    logs = []
    out = TTRAIN.train(args, log=logs.append, **kw)
    return out, logs


def test_trainer_resumes_bit_for_bit(tmp_path):
    """6 steps unbroken, against a run preempted after step 3 (checkpoint
    every 3 steps) and resumed with ``--resume``: parameters, AdamW state
    and steps 4-6's losses equal bit for bit."""
    whole, _ = _train([])
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    first, _ = _train(ckpt, stop=3)
    assert first["step"] == 3 and len(first["save_seconds"]) == 1
    second, logs = _train(ckpt + ["--resume"])
    assert "[train] resumed from step 3" in logs
    assert second["step"] == 6 and second["losses"] == whole["losses"][3:]
    assert first["losses"] == whole["losses"][:3]
    for a, b in zip(tree_leaves((second["params"], second["opt_state"])),
                    tree_leaves((whole["params"], whole["opt_state"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert TTRAIN.CheckpointManager(str(tmp_path)).all_steps() == [3, 6]


def test_trainer_starts_from_given_weights():
    """``params=`` replaces the draw from ``--seed``: the seed's own draw
    passed in repeats the run bit for bit; other weights do not."""
    args = ["--steps", "2", "--ckpt-every", "100"]
    drawn, _ = _train(args)
    cfg = get_arch("qwen3_0_6b", smoke=True)
    same, _ = _train(args, params=TM.init_params(cfg, 0, device="cpu"))
    other, _ = _train(args, params=TM.init_params(cfg, 5, device="cpu"))
    assert same["losses"] == drawn["losses"][:2]
    for a, b in zip(tree_leaves(same["params"]), tree_leaves(drawn["params"])):
        assert torch.equal(a, b)
    assert other["losses"] != same["losses"]


def _ref_ddp(jcfg, opt):
    """The reference's ``ddp_step`` body (``repro/launch/train.py``)
    under ``jax.vmap`` over the ranks (axis ``"data"``): parameters and
    state shared, residuals and batch rows per rank."""
    def ddp_step(params, opt_state, resid, step, batch):
        def loss_fn(p, b):
            return JM.train_loss(p, jcfg, b)[0]
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        grads = jax.tree.map(lambda g, r: g.astype(jnp.float32) + r,
                             grads, resid)
        grads, new_resid = j_cpsum(grads, "data")
        loss = jax.lax.pmean(loss, "data")
        grads, gnorm = j_clip(grads, 1.0)
        new_params, new_state = opt.update(grads, opt_state, params, step)
        return new_params, new_state, new_resid, loss, gnorm
    return jax.jit(jax.vmap(ddp_step, in_axes=(None, None, 0, None, 0),
                            axis_name="data"))


def test_ddp_compress_matches_the_reference(tmp_path):
    """``--mode ddp-compress`` on 2 gloo ranks (each on its half of the
    global batch) for 2 steps, against the reference's ``ddp_step`` on the
    same initial weights and batches: the mean losses, the parameters and
    moments (equal on both ranks), each rank's residuals."""
    world = 2
    outs = _torch_dist.run_ranks(_torch_dist.ddp_train_outputs, world,
                                 str(tmp_path), timeout=240)
    args = TTRAIN.build_parser().parse_args(_torch_dist.DDP_ARGS)
    cfg = get_arch(args.arch, smoke=args.smoke)
    jcfg = j_get_arch(args.arch, smoke=args.smoke)
    pipe = TTRAIN.make_pipeline(cfg, args.batch, args.seq, args.seed)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(
        TM.init_params(cfg, args.seed, device="cpu"), cfg))
    opt = j_adamw(j_warmup_cosine(args.lr, args.warmup, args.steps))
    js = opt.init(jp)
    resid = jax.tree.map(lambda p: jnp.zeros((world,) + p.shape), jp)
    step_fn = _ref_ddp(jcfg, opt)
    losses = []
    for step in range(args.steps):
        batch = {k: jnp.asarray(v.numpy().reshape(
            (world, -1) + tuple(v.shape[1:])))
            for k, v in pipe.global_batch(step).items()}
        jp, js, resid, loss, _ = step_fn(jp, js, resid, jnp.int32(step),
                                         batch)
        for tree in (jp, js):
            for leaf in jax.tree.leaves(tree):
                np.testing.assert_array_equal(leaf[0], leaf[1])
        jp, js = (jax.tree.map(lambda a: a[0], t) for t in (jp, js))
        losses.append(float(loss[0]))
    flips = total = 0
    for rank, out in enumerate(outs):
        assert out["losses"] == pytest.approx(losses, rel=1e-6)
        _adamw_close(out["params"], jp, args.steps, f"rank {rank} params")
        for part in ("mu", "nu"):
            f, t = _flipped(out["state"][part], js[part],
                            lambda w: np.abs(w).max(), 2e-4,
                            4 * args.steps / 127, f"rank {rank} {part}")
            flips, total = flips + f, total + t
        f, t = _flipped(out["resid"], jax.tree.map(lambda a: a[rank], resid),
                        lambda w: 2 * np.abs(w).max(), 2e-3, 1.01,
                        f"rank {rank} residuals")
        flips, total = flips + f, total + t
    assert flips <= 1e-4 * total, f"{flips} of {total} elements flipped"


def _flipped(got_tree, want_tree, scale, tight, loose, what):
    """Leaf by leaf, each element within ``tight · scale(leaf)`` except
    the ones an int8 rounding flipped, each within ``loose · scale``.
    Returns (flipped elements, elements)."""
    flips = total = 0
    for i, (g, w) in enumerate(zip(jax.tree.leaves(got_tree),
                                   jax.tree.leaves(want_tree))):
        w = _np(w)
        err = np.abs(_np(g) - w) / (scale(w) + 1e-30)
        assert err.max() <= loose, f"{what} leaf {i}: {err.max()}"
        flips += int((err > tight).sum())
        total += err.size
    return flips, total


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_0_6b", "internvl2_1b",
                                  "jamba_v0_1_52b"])
def test_serve_launcher_matches_the_reference_loop(arch):
    """``launch.serve`` on the float32 smoke model (a stub frontend
    decodes over drawn embeddings): the reference's prefill into an
    S + G cache and greedy decode on the same inputs give the same tokens
    and last logits (5e-5 of their scale, the models' tolerance); and the
    last decode logits equal a full forward's last logits over everything
    fed (the cache-consistency check), within the same tolerance."""
    jcfg, cfg, jp, _, tp = _models(arch, "float32")
    args = TSERVE.build_parser().parse_args(
        ["--device", "cpu", "--arch", arch, "--smoke", "--batch", "2",
         "--prompt-len", "24", "--gen", "5"])
    routes = MoERoutes()
    with routes.record() if cfg.moe_num_experts else contextlib.nullcontext():
        out = TSERVE.serve(args, params=tp, log=lambda _: None)
    fed = out["inputs"].numpy()
    Bq, P, G = 2, 24, 5
    assert out["tokens"].shape == (Bq, G)
    assert fed.shape[1] == P + G - 1
    caches = JT.stack_cache_init(jcfg, Bq, P + G)
    x, caches, _ = JM.forward(jp, jcfg, jnp.asarray(fed[:, :P]),
                              caches=caches,
                              cache_len=jnp.zeros((), jnp.int32))
    logits = (x[:, -1] @ jp["head"]["w"]).astype(jnp.float32)
    toks = [np.asarray(jnp.argmax(logits, -1))]
    for i in range(G - 1):
        logits, caches = JM.decode_step(jp, jcfg, caches, jnp.int32(P + i),
                                        jnp.asarray(fed[:, P + i:P + i + 1]))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(toks, 1))
    scale = float(np.abs(np.asarray(logits)).max())
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(logits),
                               rtol=0, atol=5e-5 * scale)
    with torch.no_grad():
        h, _, _ = TM.forward(tp, cfg, out["inputs"])
    full = (h[:, -1] @ tp["head"]["w"]).float()
    np.testing.assert_allclose(out["logits"].numpy(), full.numpy(), rtol=0,
                               atol=5e-5 * scale)


# ---------------------------------------------------------------------------
# the flash kernels are forward only
# ---------------------------------------------------------------------------

def test_flash_entries_refuse_inputs_that_require_grad():
    """Each kernel entry a model forward reaches raises before it touches
    a device when an input requires grad in grad mode (the kernel's output
    would be cut off from the graph); under ``no_grad`` the same call goes
    on to the device check. The CPU's plain attention stays
    differentiable."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    lm = torch.zeros(1, 2, 8)
    calls = [lambda: tfa.flash_attention(q, k, v),
             lambda: tfa.flash_centroid_attention(q, k, v, lm),
             lambda: tfa.flash_centroid_decode(
                 q[:, :, :1].transpose(1, 2), k[0], v[0], lm[0],
                 torch.ones(2, 8, dtype=torch.bool))]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward only"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()
    out = tops.flash_attention(q, k, v)
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
