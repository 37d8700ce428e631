"""The trainer's mesh-sharded pjit mode on DTensor against the reference's
pjit step, on four gloo ranks as a (2, 2) ("data", "model") mesh.

The reference runs in one subprocess with 4 forced CPU devices
(``tests/test_distributed.py::run_with_devices``' way), the port's ranks
alongside it (``_torch_dist.run_ranks``); both read the same float32
Qwen3-smoke parameters (the reference's ``init_params``, carried into the
port by ``params_from_numpy``), batch and MoE inputs, written as numpy by
the test. Held:

- every parameter's shard on each rank: the index ranges of its local
  shard equal the reference's ``NamedSharding(...).devices_indices_map``
  on the same mesh (rank r is device r), also on a (2, 1, 2) ("pod",
  "data", "model") mesh, where fsdp cuts a dim pod-major; a dim that its
  mesh axes do not divide raises in both packages;
- the pjit step (AdamW, lr 1e-3): step 1's loss within 1e-6 relative
  and gradients within 5e-5 of each leaf's largest magnitude (the
  float32 tolerance of ``test_torch_train.py``: the sharded step sums
  across ranks in another order); 8 steps' losses within 1e-4 relative;
  the parameters after 8 steps counted as ``test_torch_train.py`` counts
  AdamW parameters (a gradient near eps flips a step); the same bounds
  against the port's own single-process step;
- the mesh step of Granite's, SmolLM's and Jamba's smoke configs, which
  take the attention's q-group and key-sequence modes and Mamba with
  the experts cut over "model": step 1's loss and gradients against the
  reference's on its mesh, with the bounds above;
- the MoE block (Jamba's smoke, float32, capacity factor 0.5) at dp = 2:
  the group count g = gcd(T, dp), the dropped (token, choice) pairs, the
  output, the aux loss and the gradients, against the reference's block
  under ``activation_sharding`` on the same mesh, and the one-group
  block against the reference's one-group block;
- the sharded fits' 1-axis mesh over every rank and over the
  first two, against the reference's over its first devices;
- checkpoints cross topologies: one written on the mesh restores on one
  process, one written on one process resumes on the mesh, bit for bit.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import filelock
import jax
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs import get_arch as j_get_arch
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.launch import train as TTRAIN
from repro_torch.models.convert import params_to_numpy
from repro_torch.utils.tree import tree_leaves

from test_torch_train import _adamw_close, _leaves_close

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's side, run with 4 forced CPU devices
REFERENCE = """
import contextlib, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.launch.mesh import (make_cluster_mesh, make_test_mesh,
                               resolve_spec, shardings_for)
from repro.launch.steps import make_train_step
from repro.models import moe as M
from repro.models import param_specs, train_loss
from repro.models.sharding import activation_sharding
from repro.optim import adamw
work, steps, moe_b, moe_s, moe_cap = sys.argv[1:6]
load = lambda n: pickle.load(open(f"{work}/{n}", "rb"))
cfg = get_arch("qwen3_0_6b", smoke=True)
params, batch = load("params.pkl"), load("batch.pkl")
specs = param_specs(cfg)
out = {"ranges": {}}
is_p = lambda s: isinstance(s, P)

def boxes(mesh):
    def one(spec, a):
        m = NamedSharding(mesh, resolve_spec(spec, mesh)
                          ).devices_indices_map(a.shape)
        return {d.id: tuple((s.start or 0, a.shape[i] if s.stop is None
                             else s.stop) for i, s in enumerate(idx))
                for d, idx in m.items()}
    return jax.tree.map(one, specs, params, is_leaf=is_p)

mesh = make_test_mesh((2, 2))
out["ranges"]["2x2"] = boxes(mesh)
out["ranges"]["pod"] = boxes(make_test_mesh((2, 1, 2),
                                            ("pod", "data", "model")))
try:
    jax.device_put(np.zeros((3, 4), np.float32),
                   NamedSharding(mesh, P("data", "model")))
    out["indivisible"] = None
except Exception as e:
    out["indivisible"] = str(e)
out["specs"] = jax.tree.map(tuple, specs, is_leaf=is_p)
out["cluster"] = {n: (m.axis_names, [d.id for d in m.devices.flat])
                  for n in (None, 2) for m in [make_cluster_mesh(n)]}

opt = adamw(1e-3)
p = jax.device_put(jax.tree.map(jnp.asarray, params),
                   shardings_for(specs, mesh))
s = jax.device_put(opt.init(p), shardings_for(opt.state_specs(specs, p),
                                              mesh))
b = jax.device_put(jax.tree.map(jnp.asarray, batch),
                   NamedSharding(mesh, P("data")))
np_tree = lambda t: jax.tree.map(np.asarray, t)
with mesh, activation_sharding(mesh):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: train_loss(p, cfg, b), has_aux=True))(p, b)
    out["loss"], out["grads"] = float(loss), np_tree(grads)
    step = jax.jit(make_train_step(cfg, opt), donate_argnums=(0, 1))
    losses = []
    for i in range(int(steps)):
        p, s, _, metrics = step(p, s, jnp.int32(i), b)
        losses.append(float(metrics["loss"]))
out["losses"], out["params"], out["state"] = losses, np_tree(p), np_tree(s)

import dataclasses, math
mcfg = dataclasses.replace(get_arch("jamba_v0_1_52b", smoke=True),
                           moe_capacity_factor=float(moe_cap))
mp, x, r = load("moe.pkl")
T = int(moe_b) * int(moe_s)

def moe_run(p, x):
    y, aux = M.moe_apply(p, x, mcfg)
    g = math.gcd(T, M.dp_size())
    tl, e, k = T // g, mcfg.moe_num_experts, mcfg.moe_top_k
    cap = max(8, -(-int(mcfg.moe_capacity_factor * tl * k / e) // 8) * 8)
    xf = x.reshape(g, tl, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    keep = jax.vmap(lambda a, b: M._dispatch_local(a, b, k, e, cap)[3])(
        xf, probs)
    return y, aux, (~keep).sum()

def moe_grads(p, x):
    y, aux = M.moe_apply(p, x, mcfg)
    return jnp.sum(y * r) + aux

for name, ctx in (("moe", True), ("moe_single", False)):
    xs = jnp.asarray(x)
    with (mesh if ctx else contextlib.nullcontext()), \
            (activation_sharding(mesh) if ctx else contextlib.nullcontext()):
        y, aux, drop = jax.jit(moe_run)(mp, xs)
        gp, gx = jax.jit(jax.grad(moe_grads, argnums=(0, 1)))(mp, xs)
        g = math.gcd(T, M.dp_size())
    out[name] = {"g": g, "y": np.asarray(y), "aux": float(aux),
                 "dropped": int(drop),
                 "grads": np_tree(gp) | {"x": np.asarray(gx)}}
pickle.dump(out, open(f"{work}/reference.pkl", "wb"))
"""


#: the reference's step-1 loss and gradients of ``_torch_dist.MODE_ARCHS``
#: on its (2, 2) mesh, in a second process beside ``REFERENCE``
REFERENCE_MODES = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.launch.mesh import make_test_mesh, shardings_for
from repro.models import param_specs, train_loss
from repro.models.sharding import activation_sharding
work, archs = sys.argv[1:3]
load = lambda n: pickle.load(open(f"{work}/{n}", "rb"))
mesh = make_test_mesh((2, 2))
out = {}
for arch in archs.split(","):
    cfg = get_arch(arch, smoke=True)
    p = jax.device_put(jax.tree.map(jnp.asarray, load(f"params_{arch}.pkl")),
                       shardings_for(param_specs(cfg), mesh))
    b = jax.device_put(jax.tree.map(jnp.asarray, load(f"batch_{arch}.pkl")),
                       NamedSharding(mesh, P("data")))
    with mesh, activation_sharding(mesh):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: train_loss(p, cfg, b), has_aux=True))(p, b)
    out[arch] = {"loss": float(loss),
                 "grads": jax.tree.map(np.asarray, grads)}
pickle.dump(out, open(f"{work}/reference_modes.pkl", "wb"))
"""


def _dump(work, name, obj):
    with open(os.path.join(work, name), "wb") as f:
        pickle.dump(obj, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's rank results, the reference's results): the reference's
    subprocess and the port's four ranks, run at once and only once for
    all test workers (the first to take the lock runs them; the others
    read its results)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):    # the workers' common dir
        root = root.parent
    done = root / "mesh_train.pkl"
    with filelock.FileLock(str(root / "mesh_train.lock")):
        if not done.exists():
            work = str(tmp_path_factory.mktemp("mesh_train"))
            _dump(str(root), "mesh_train.part", _run(work))
            os.replace(root / "mesh_train.part", done)
    with open(done, "rb") as f:
        return pickle.load(f)


def _run(work: str):
    jcfg = j_get_arch("qwen3_0_6b", smoke=True)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("inputs", "labels")}
    mcfg = j_get_arch("jamba_v0_1_52b", smoke=True)
    moe = jax.tree.map(np.asarray, JMoE.moe_init(jax.random.PRNGKey(2),
                                                 mcfg))
    x, r = np.random.default_rng(3).standard_normal(
        (2, _torch_dist.MOE_B, _torch_dist.MOE_S, mcfg.d_model)
    ).astype(np.float32)
    _dump(work, "params.pkl", params)
    _dump(work, "batch.pkl", batch)
    _dump(work, "moe.pkl", (moe, x, r))
    for i, arch in enumerate(_torch_dist.MODE_ARCHS):
        acfg = j_get_arch(arch, smoke=True)
        _dump(work, f"params_{arch}.pkl", jax.tree.map(
            np.asarray, JM.init_params(acfg, jax.random.PRNGKey(4 + i))))
        _dump(work, f"batch_{arch}.pkl", {
            k: rng.integers(0, acfg.vocab_size, (4, 32)).astype(np.int32)
            for k in ("inputs", "labels")})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script), work, *argv],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for script, argv in (
            (REFERENCE, [str(_torch_dist.MESH_STEPS), str(_torch_dist.MOE_B),
                         str(_torch_dist.MOE_S),
                         str(_torch_dist.MOE_CAPACITY)]),
            (REFERENCE_MODES, [",".join(_torch_dist.MODE_ARCHS)]))]
    try:
        ours = _torch_dist.run_ranks(_torch_dist.mesh_train_outputs, 4,
                                     work, timeout=240, work=work)
    finally:
        errs = [ref.communicate(timeout=300)[1] for ref in refs]
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-3000:]
    theirs = {}
    for name in ("reference.pkl", "reference_modes.pkl"):
        with open(os.path.join(work, name), "rb") as f:
            theirs[name] = pickle.load(f)
    return ours, theirs["reference.pkl"] | {
        "modes": theirs["reference_modes.pkl"]}


def _boxes_of_rank(tree, rank):
    """The reference's per-device boxes at device ``rank``."""
    return jax.tree.map(lambda m: m[rank], tree,
                        is_leaf=lambda m: isinstance(m, dict)
                        and 0 in m)


@pytest.mark.parametrize("mesh", ["2x2", "pod"])
def test_every_rank_holds_the_reference_shard(runs, mesh):
    """Each rank's local shard of every Qwen3-smoke parameter is the box
    that the reference's ``NamedSharding`` gives device ``rank``: on the
    (2, 2) mesh and on (2, 1, 2), where fsdp cuts pod-major."""
    ours, theirs = runs
    for rank, out in enumerate(ours):
        want = _boxes_of_rank(theirs["ranges"][mesh], rank)
        got = out["ranges"][mesh]
        got_leaves = jax.tree.leaves(got, is_leaf=lambda b: isinstance(
            b, tuple) and all(isinstance(r, tuple) for r in b))
        want_leaves = jax.tree.leaves(want, is_leaf=lambda b: isinstance(
            b, tuple) and all(isinstance(r, tuple) for r in b))
        assert len(got_leaves) == len(want_leaves) > 0
        for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
            if len(w) == len(g) + 1:       # a stacked leaf: its layers whole
                assert w[0][0] == 0, f"rank {rank} leaf {i}"
                w = w[1:]
            assert tuple(g) == tuple(w), f"{mesh} rank {rank} leaf {i}"


def test_an_indivisible_dim_raises_in_both(runs):
    ours, theirs = runs
    assert theirs["indivisible"] is not None
    for out in ours:
        assert "does not divide" in out["indivisible"]


@pytest.mark.parametrize("n", [None, 2])
def test_cluster_mesh_spans_the_reference_devices(runs, n):
    """``make_cluster_mesh(n)`` on four gloo ranks is the reference's 1-D
    ("data",) mesh of its first ``n`` devices (all with ``None``): rank r
    of the group is device r, gloo on the CPU, and the ranks past ``n``
    hold no place on it."""
    ours, theirs = runs
    axes, ids = theirs["cluster"][n]
    assert axes == ("data",)
    members = [r for r, out in enumerate(ours) if n in out["cluster"]]
    assert members == ids == list(range(n or 4))
    for r in members:
        assert ours[r]["cluster"][n] == ("data", len(ids), r, "gloo")


def test_param_specs_in_the_reference_layout(runs):
    """The rank's ``param_specs`` in the reference's layout are the
    reference's ``param_specs``, axis name by axis name."""
    ours, theirs = runs
    assert ours[0]["specs"] == theirs["specs"]


def test_step_one_loss_and_gradients_match_the_reference(runs):
    ours, theirs = runs
    for name in ("mesh", "single"):
        out = ours[0][name]
        assert out["loss"] == pytest.approx(theirs["loss"], rel=1e-6), name
        _leaves_close(out["grads"], theirs["grads"], 5e-5, f"{name} grads")
    _leaves_close(ours[0]["mesh"]["grads"], ours[0]["single"]["grads"],
                  5e-5, "mesh against single grads")


def test_mesh_steps_match_the_reference_pjit_step(runs):
    """8 AdamW steps of the mesh step against the reference's pjit step
    on its (2, 2) mesh and against the port's single-process step."""
    ours, theirs = runs
    mesh, single = ours[0]["mesh"], ours[0]["single"]
    steps = _torch_dist.MESH_STEPS
    assert mesh["losses"] == pytest.approx(theirs["losses"], rel=1e-4)
    assert mesh["losses"] == pytest.approx(single["losses"], rel=1e-4)
    assert theirs["losses"][-1] < theirs["losses"][0]
    _adamw_close(mesh["params"], theirs["params"], steps, "mesh params")
    _adamw_close(mesh["params"], single["params"], steps,
                 "mesh against single params")
    for part in ("mu", "nu"):
        _leaves_close(mesh["state"][part], theirs["state"][part], 2e-4,
                      f"mesh {part}")


#: the path each of ``MODE_ARCHS`` takes on the (2, 2) mesh, from its
#: heads: (kv heads, q heads)
MODES = {"granite_34b": ("q groups", 1, 4), "smollm_360m": ("key sequence",
                                                             1, 3),
         "jamba_v0_1_52b": ("kv heads", 2, 4)}


@pytest.mark.parametrize("arch", _torch_dist.MODE_ARCHS)
def test_attention_modes_and_mamba_match_the_reference_pjit_step(runs,
                                                                  arch):
    """The mesh step of a config on each of the attention's other score
    modes (the reference's ``attn_apply``: kv heads when "model" divides
    them, else q groups, else the key sequence) and of Jamba (Mamba, and
    the MoE experts cut over "model"), against the reference's pjit step
    on its (2, 2) mesh: step 1's loss (1e-6 relative) and gradients (5e-5
    of each leaf's scale: a rank that holds only its share of a
    gradient, of k and v over the q groups or of q over the key blocks,
    must have it summed)."""
    ours, theirs = runs
    cfg = get_arch(arch, smoke=True)
    mode, hkv, hq = MODES[arch]
    assert (cfg.num_kv_heads, cfg.num_heads) == (hkv, hq)
    g = hq // hkv
    assert mode == ("kv heads" if hkv % 2 == 0 else "q groups" if g % 2 == 0
                    else "key sequence")
    got, want = ours[0]["modes"][arch], theirs["modes"][arch]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    _leaves_close(got["grads"], want["grads"], 5e-5, f"{arch} grads")


@pytest.mark.parametrize("which", ["moe", "moe_single"])
def test_moe_groups_and_drops_at_dp_2(runs, which):
    """The MoE block at dp = 2 (g = gcd(T, 2) = 2 groups, each with its
    own capacity; on the (2, 2) mesh each rank of "model" runs half the
    experts) and with no mesh (one group): g, the dropped pairs, the
    output, the aux loss and the gradients of sum(y · r) + aux (5e-5 of
    each leaf's scale) equal the reference's."""
    ours, theirs = runs
    got, want = ours[0][which], theirs[which]
    assert got["g"] == want["g"] == (2 if which == "moe" else 1)
    assert got["dropped"] == want["dropped"] > 0
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    assert got["aux"] == pytest.approx(want["aux"], rel=1e-5)
    _leaves_close(got["grads"], want["grads"], 5e-5, f"{which} grads")
    if which == "moe":
        assert got["dropped"] != ours[0]["moe_single"]["dropped"]


def _restore_one_process(ckpt_dir, cfg):
    """A checkpoint restored on one process, as the reference layout."""
    args = TTRAIN.build_parser().parse_args(_torch_dist.MESH_ARGS)
    params = TTRAIN.init_params(cfg, args.seed, device="cpu")
    state = TTRAIN.adamw(1e-3).init(params)
    tree, step = CheckpointManager(ckpt_dir).restore(
        TTRAIN.checkpoint_target(params, state, cfg))
    params, state = TTRAIN.from_checkpoint(tree, cfg, "cpu")
    return step, params_to_numpy(params, cfg), {
        k: params_to_numpy(v, cfg) for k, v in state.items()}


def test_checkpoints_cross_between_mesh_and_one_process(tmp_path):
    """A checkpoint written on the (2, 2) mesh restores on one process,
    and one written on one process resumes on the mesh: the restored
    parameters and AdamW state equal the saved ones bit for bit."""
    work = str(tmp_path)
    args = TTRAIN.build_parser().parse_args(
        _torch_dist.MESH_ARGS + ["--ckpt-dir", os.path.join(work,
                                                            "ck_single")])
    single = TTRAIN.train(args, log=lambda _: None)
    cfg = get_arch(args.arch, smoke=args.smoke)
    outs = _torch_dist.run_ranks(_torch_dist.mesh_checkpoint_outputs, 4,
                                 work, timeout=240, work=work)
    wrote, resumed = outs[0]["wrote"], outs[0]["resumed"]
    step, params, state = _restore_one_process(os.path.join(work, "ck_mesh"),
                                               cfg)
    assert step == wrote["step"] == 2
    for got, want in ((params, wrote["params"]), (state, wrote["state"]),
                      (resumed["params"], params_to_numpy(single["params"],
                                                          cfg))):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert resumed["step"] == 2
    for k, v in single["opt_state"].items():
        for a, b in zip(jax.tree.leaves(resumed["state"][k]),
                        tree_leaves(params_to_numpy(v, cfg))):
            np.testing.assert_array_equal(a, b)
