"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``), and the reference's own checks of them
(``tests/test_substrate.py``) on the port.

The same numpy parameters and per-step gradients (from a seed) go
through three steps of each optimizer in both packages. Tolerances, with
their reasons:

- float32 parameters and state: 4 float32 ulps (2^-21) of the leaf's
  largest magnitude: both packages compute the same float32 expressions
  in the same order, but XLA may fuse a multiply and an add into one
  rounding (the moments' ``b · m + (1 - b) · g``), and the two
  libraries' ``pow`` (the bias corrections ``b ** (step + 1)``), ``sqrt``
  / ``rsqrt`` and reductions (Adafactor's means, the global norm) may
  round the last bit differently. Where the two terms of a moment cancel,
  that bit is one of the terms', not of the small result, hence the
  leaf's scale; three steps carry it on;
- bfloat16 parameters and Adafactor's bfloat16 first moment: one bf16
  ulp: a float32 result one ulp apart can round to either bf16
  neighbour.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                               warmup_cosine)
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map

torch.set_num_threads(1)

F32_TOL = 2.0 ** -21
SHAPES = {"w": (16, 8), "b": (5,), "s": (3, 4, 6), "v": (1, 7)}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _trees(dtype: str, seed: int = 0):
    """(params, [grads of 3 steps]) as numpy, params at ``dtype``."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)
                  ).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    if dtype == "bfloat16":
        params = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                  for k, v in params.items()}
        grads = [{k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                  for k, v in g.items()} for g in grads]
    return params, grads


def _close(got, want, what):
    """``got`` (the port's leaf) within the module's tolerance of
    ``want``."""
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        w = _np(want)
        # one bf16 ulp: 2^-7 of the value's binade
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(_np(got) - w) <= ulp), what
    else:
        w = _np(want)
        np.testing.assert_allclose(_np(got), w, rtol=0, atol=F32_TOL * float(
            np.abs(w).max()), err_msg=what)


OPTS = {
    "adamw": (lambda: j_adamw(3e-2, weight_decay=0.1),
              lambda: adamw(3e-2, weight_decay=0.1)),
    "adamw_schedule": (
        lambda: j_adamw(j_warmup_cosine(1e-2, 2, 10)),
        lambda: adamw(warmup_cosine(1e-2, 2, 10))),
    "adafactor": (lambda: j_adafactor(1e-2),
                  lambda: adafactor(1e-2)),
    "adafactor_decay": (
        lambda: j_adafactor(j_warmup_cosine(1e-2, 1, 5), weight_decay=0.05,
                            clip_rms=0.5),
        lambda: adafactor(warmup_cosine(1e-2, 1, 5), weight_decay=0.05,
                          clip_rms=0.5)),
}


@pytest.mark.parametrize("name", list(OPTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_three_steps_match_the_reference(name, dtype):
    """Three updates of the same gradients: parameters and every state
    leaf (Adafactor: factored ``w``, ``s``, ``v``; unfactored ``b``)."""
    make_j, make_t = OPTS[name]
    params, grads = _trees(dtype)
    jo, to = make_j(), make_t()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: tensor_from_numpy(v, "cpu") for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        jp, js = jax.jit(jo.update)({k: jnp.asarray(v) for k, v in g.items()},
                                    js, jp, jnp.int32(step))
        tp, ts = to.update({k: tensor_from_numpy(v, "cpu")
                            for k, v in g.items()}, ts, tp, step)
        for k in SHAPES:
            assert tp[k].dtype == tensor_from_numpy(params[k], "cpu").dtype
            _close(tp[k], jp[k], f"{name} step {step} param {k}")
        for part in js:
            for k in SHAPES:
                assert tuple(ts[part][k].shape) == js[part][k].shape
                _close(ts[part][k], js[part][k],
                       f"{name} step {step} {part}[{k}]")


def test_adafactor_state_is_factored():
    opt = adafactor(0.1)
    params = {"w": torch.zeros((16, 8)), "b": torch.zeros((5,))}
    st = opt.init(params)
    assert st["vr"]["w"].shape == (16,)
    assert st["vc"]["w"].shape == (8,)
    assert st["vr"]["b"].shape == (5,)
    assert st["vc"]["b"].shape == (1,)
    assert st["mu"]["w"].dtype == torch.bfloat16
    j = j_adafactor(0.1).init({"w": jnp.zeros((16, 8)), "b": jnp.zeros((5,))})
    assert tree_map(lambda t: tuple(t.shape), st) == \
        jax.tree.map(lambda a: a.shape, j, is_leaf=lambda x: hasattr(x, "shape"))


def test_adamw_first_step_matches_closed_form():
    """``tests/test_substrate.py``'s first-step check, on the port."""
    opt = adamw(0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0)
    params = {"w": torch.tensor([1.0, 2.0])}
    grads = {"w": torch.tensor([0.5, -0.5])}
    p2, _ = opt.update(grads, opt.init(params), params, 0)
    m_hat = 0.1 * grads["w"]
    v_hat = 0.01 * grads["w"] ** 2
    expect = params["w"] - 0.1 * (m_hat / 0.1) / (torch.sqrt(v_hat / 0.01)
                                                   + 1e-8)
    np.testing.assert_allclose(p2["w"].numpy(), expect.numpy(), rtol=1e-5)


@pytest.mark.parametrize("make", [lambda: adamw(0.05),
                                  lambda: adafactor(0.05)])
def test_optimizers_descend_quadratic(make):
    opt = make()
    params = {"w": torch.ones((4, 8)) * 3.0}
    st = opt.init(params)
    for step in range(50):
        g = {"w": 2 * params["w"]}
        params, st = opt.update(g, st, params, step)
    assert float((params["w"] ** 2).sum()) < 8.0 * 9 * 4 * 0.25


def test_clip_by_global_norm_matches_the_reference():
    """The substrate's (3, 4) case, then a tree of float32 and bf16
    leaves: the norm within a float32 ulp or two (the leaves are summed
    in the same order, each leaf's reduction by its own library), each
    clipped leaf in its own dtype."""
    clipped, gn = clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert abs(float(gn) - 5.0) < 1e-5
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-5)
    params, grads = _trees("float32", seed=1)
    bf = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
          for k, v in grads[0].items()}
    tree = {"f": grads[0], "h": [bf["w"], bf["b"]]}
    jt, jn = j_clip(jax.tree.map(jnp.asarray, tree), 0.5)
    tt, tn = clip_by_global_norm(tree_map(
        lambda a: tensor_from_numpy(a, "cpu"), tree), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=2.5e-7)
    assert float(tn) > 0.5
    for got, want in zip(tree_leaves(tt), jax.tree.leaves(jt)):
        _close(got, want, "clipped leaf")
    untouched, _ = clip_by_global_norm(tt, 1e9)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(untouched),
                                                 tree_leaves(tt)))


@pytest.mark.parametrize("warmup,total,floor", [(10, 110, 0.1), (0, 7, 0.0),
                                                (3, 3, 0.5)])
def test_warmup_cosine_matches_the_reference(warmup, total, floor):
    """Every step up to past ``total``: float32 within 4 ulps (2^-21
    relative; the libraries' ``cos`` may round its last bit differently,
    and the products after it carry that bit on); the substrate's shape
    checks at (10, 110)."""
    j = j_warmup_cosine(1.0, warmup, total, floor)
    t = warmup_cosine(1.0, warmup, total, floor)
    for step in range(total + 3):
        got = t(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j(jnp.int32(step))),
                                   rtol=F32_TOL, atol=0)
        assert float(t(torch.tensor(step))) == float(got)
    if (warmup, total) == (10, 110):
        assert float(t(0)) < 0.2
        assert abs(float(t(9)) - 1.0) < 0.01
        assert float(t(109)) < 0.2


def test_optimizer_trees_keep_their_structure():
    """Nested dicts, lists and tuples come back in the same shape, leaf
    for leaf (``utils.tree``'s JAX order)."""
    params = {"z": [torch.ones(3), (torch.ones(2, 2),)], "a": torch.ones(4)}
    for opt in (adamw(0.1), adafactor(0.1)):
        new, st = opt.update(tree_map(torch.ones_like, params),
                             opt.init(params), params, 0)
        assert tree_flatten(new)[1] == tree_flatten(params)[1]
        assert isinstance(new["z"], list) and isinstance(new["z"][1], tuple)
