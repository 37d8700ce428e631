"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``) and
training states crossing between the packages through it.

The manager's own contract mirrors ``tests/test_substrate.py`` (round
trip, retention, async and atomic saves, a missing directory raises).
Its files are the reference's: the same leaf numbering (JAX's flatten
order), treedef string and ``.npy`` bytes, bfloat16 included. Across the
seam: the reference trains the bf16 Qwen3 smoke model for 2 steps and
saves ``(params, opt_state)``; the port restores that state bit for bit
and trains 2 more steps, which must land within the tolerance below of
the reference's own 4-step run; and the reference's ``restore`` reads
the port's files bit for bit, once its ``|V2`` leaves (the reference's
own bfloat16 restore fault, ROADMAP.md Queue 3) are viewed as bfloat16.

Tolerance of the 2 further steps (bf16 parameters, float32 AdamW state):
each AdamW step moves an element by at most ``lr · (1 + wd·|p|)``
(its update ``m̂ / (√v̂ + eps)`` is at most 1 in size), and where the two
packages' bf16 gradients differ in sign or size the updates differ by
up to twice that; on top, the bf16 rounding of the result (one bf16 ulp
of the value). So every parameter lies within ``2 · steps · lr`` plus a
bf16 ulp of the reference's, and on average within 2^-7 of the largest
difference that bound allows.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_arch as j_get_arch
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import model as JM
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import (checkpoint_target, from_checkpoint,
                                      to_checkpoint)
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.utils.tree import tree_flatten, tree_leaves, treedef_str

torch.set_num_threads(1)

LR = 1e-3


def _np(a) -> np.ndarray:
    """Any leaf as float32 (or integer) numpy; ``|V2`` words as bf16."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    if a.dtype == np.dtype("V2"):
        a = a.view(ml_dtypes.bfloat16)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def test_checkpoint_roundtrip_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"p": torch.arange(6).reshape(2, 3), "n": {"x": torch.ones(4)}}
    for s in (1, 2, 3):
        cm.save(s, {"p": tree["p"] * s, "n": {"x": tree["n"]["x"] * s}})
    assert cm.all_steps() == [2, 3]                   # retention
    restored, step = cm.restore(tree)
    assert step == 3
    assert torch.equal(restored["p"], tree["p"] * 3)
    assert restored["n"]["x"].dtype == torch.float32
    back, step = cm.restore(tree, step=2, device="cpu")
    assert step == 2 and torch.equal(back["n"]["x"], tree["n"]["x"] * 2)


def test_checkpoint_async_and_atomic(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = torch.zeros(1000)
    cm.save(7, {"a": t}, wait=False)
    t += 1                         # the snapshot was taken at save time
    cm.wait_for_save()
    assert cm.latest_step() == 7
    assert not any(f.startswith("tmp.") for f in os.listdir(tmp_path))
    assert torch.equal(cm.restore({"a": 0})[0]["a"], torch.zeros(1000))


def test_checkpoint_restore_missing_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        cm.restore({"a": torch.zeros(1)})
    missing = os.path.join(str(tmp_path), "nowhere")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(missing, create=False).latest_step()
    assert not os.path.exists(missing)
    cm.save(1, {"a": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaves"):
        cm.restore({"a": 0, "b": 0})


def test_files_are_the_reference_files(tmp_path):
    """The same tree saved by both packages: the same manifest (treedef
    string included) and the same bytes in every leaf file, bfloat16 as
    the reference's ``'<V2'``; each package restores the other's."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = f32.astype(ml_dtypes.bfloat16)
    ints = rng.integers(-9, 9, (4,)).astype(np.int32)
    mask = rng.random(6) < 0.5
    jtree = ({"w": jnp.asarray(f32), "b": [jnp.asarray(bf), None]},
             {"n": jnp.asarray(ints), "m": (jnp.asarray(mask),)})
    ttree = ({"w": torch.from_numpy(f32),
              "b": [torch.from_numpy(f32).to(torch.bfloat16), None]},
             {"n": torch.from_numpy(ints), "m": (torch.from_numpy(mask),)})
    assert treedef_str(ttree) == str(jax.tree_util.tree_structure(jtree))
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    JCheckpointManager(jdir).save(4, jtree)
    CheckpointManager(tdir).save(4, ttree, extra={"k": 1})
    jm, tm = (JCheckpointManager(d).load_manifest() for d in (jdir, tdir))
    assert tm == dict(jm, extra={"k": 1})
    for leaf in jm["leaves"]:
        with open(os.path.join(jdir, "step_00000004", leaf["file"]),
                  "rb") as fj, \
                open(os.path.join(tdir, "step_00000004", leaf["file"]),
                     "rb") as ft:
            assert fj.read() == ft.read(), leaf
    back, _ = CheckpointManager(jdir, create=False).restore(ttree)
    assert back[0]["b"][0].dtype == torch.bfloat16
    for got, want in zip(tree_leaves(back), tree_leaves(ttree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    jback, _ = JCheckpointManager(tdir).restore(jtree)
    assert jback[0]["b"][0].dtype == np.dtype("V2")   # the reference's fault
    for got, want in zip(jax.tree.leaves(jback), jax.tree.leaves(jtree)):
        got = got.view(ml_dtypes.bfloat16) if got.dtype == np.dtype("V2") \
            else got
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's bf16 Qwen3 smoke model: 4 AdamW steps on seeded
    numpy batches, ``(params, opt_state)`` saved after step 2."""
    cfg = dataclasses.replace(j_get_arch("qwen3_0_6b", smoke=True),
                              dtype="bfloat16")
    opt = j_adamw(LR)
    step_fn = jax.jit(j_make_train_step(cfg, opt))
    rng = np.random.default_rng(7)
    batches = [{k: rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
                for k in ("inputs", "labels")} for _ in range(4)]
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    state = opt.init(params)
    ckpt = str(tmp_path_factory.mktemp("ref_ckpt"))
    for s, b in enumerate(batches):
        params, state, _, _ = step_fn(params, state, jnp.int32(s),
                                      jax.tree.map(jnp.asarray, b))
        if s == 1:
            JCheckpointManager(ckpt).save(2, (params, state))
    return cfg, batches, ckpt, (params, state)


def test_port_resumes_the_reference_training_state(ref_run):
    """The port restores the reference's step-2 checkpoint bit for bit,
    trains steps 3 and 4 on the same batches, and lands within the module
    docstring's tolerance of the reference's 4-step run."""
    jcfg, batches, ckpt, (jp4, js4) = ref_run
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("qwen3_0_6b", smoke=True),
                              dtype="bfloat16")
    from repro_torch.models import init_params
    fresh = init_params(cfg, 1, device="cpu")
    opt = adamw(LR)
    tree, step = CheckpointManager(ckpt, create=False).restore(
        checkpoint_target(fresh, opt.init(fresh), cfg))
    assert step == 2
    jtree, _ = JCheckpointManager(ckpt).restore((jp4, js4))
    for got, want in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
        want = want.view(ml_dtypes.bfloat16) if want.dtype == np.dtype("V2") \
            else want
        assert got.dtype == (torch.bfloat16 if want.dtype.name == "bfloat16"
                             else torch.float32)
        np.testing.assert_array_equal(_np(got), _np(want))
    params, state = from_checkpoint(tree, cfg, "cpu")
    train_step = make_train_step(cfg, opt)
    for s in (2, 3):
        params, state, _, _ = train_step(
            params, state, s, {k: torch.from_numpy(v)
                               for k, v in batches[s].items()})
    got = to_checkpoint(params, state, cfg)
    bound = 2 * 2 * LR * (1 + 0.1 * 4)
    for (g, w) in zip(tree_leaves(got[0]), jax.tree.leaves(jp4)):
        g, w = _np(g), _np(w)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        err = np.abs(g - w)
        assert np.all(err <= bound + ulp)
        assert err.mean() <= 2.0 ** -7 * (bound + ulp.max())


def test_reference_restores_the_port_training_state(ref_run, tmp_path):
    """The port's ``to_checkpoint`` of a training state, written by the
    port's manager, read by the reference's ``restore`` into its own tree:
    every leaf bit for bit, ``|V2`` leaves viewed as bfloat16."""
    jcfg, _, ckpt, (jp4, js4) = ref_run
    cfg = dataclasses.replace(
        __import__("repro_torch.configs", fromlist=["get_arch"])
        .get_arch("qwen3_0_6b", smoke=True), dtype="bfloat16")
    npp = jax.tree.map(np.asarray, jp4)
    nps = jax.tree.map(np.asarray, js4)
    params = params_from_numpy(npp, cfg, device="cpu")
    state = {k: params_from_numpy(v, cfg, device="cpu")
             for k, v in nps.items()}
    cm = CheckpointManager(str(tmp_path))
    cm.save(9, to_checkpoint(params, state, cfg), wait=False)
    cm.wait_for_save()
    back, step = JCheckpointManager(str(tmp_path)).restore((jp4, js4))
    assert step == 9
    leaves, _ = tree_flatten((npp, nps))
    for got, want in zip(jax.tree.leaves(back), leaves):
        if got.dtype == np.dtype("V2"):
            got = got.view(ml_dtypes.bfloat16)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
