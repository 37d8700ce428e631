"""Spawned gloo ranks for the port's distributed tests (``test_torch_*``).

``run_ranks(fn, world, tmpdir, timeout)`` starts ``world`` processes (the
``spawn`` method), each joining a gloo process group through a
``FileStore`` file in ``tmpdir`` (no fixed port, so files may run in
parallel), runs ``fn(rank, world, **kwargs)`` and returns every rank's
result in rank order. A rank that raises fails the call with its
traceback; ranks still running after ``timeout`` seconds are killed and
the call fails. ``single_rank_group`` is the same group of one, in this
process. ``fn`` must be importable by the children, so it lives in a
module like this one, which imports no JAX.
"""
from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import time
import traceback


def _rank_main(fn, rank: int, world: int, rdv: str, q, kwargs: dict,
               backend: str = "gloo"):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"file://{rdv}",
                                rank=rank, world_size=world)
        try:
            out = fn(rank, world, **kwargs)
        finally:
            dist.destroy_process_group()
        q.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which fails the test
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world: int, tmpdir: str, timeout: float,
              backend: str = "gloo", **kwargs) -> list:
    """Every rank's ``fn(rank, world, **kwargs)``, in rank order, on a
    ``backend`` group (NCCL: rank r on card r).

    Keep ``kwargs`` small (paths, not arrays): ``Process.start`` writes
    them down a pipe, and once that is full it waits for the child to
    start up and read them, so the ranks would start one after another.
    """
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    rdv = os.path.join(str(tmpdir), f"rendezvous_{world}_{os.getpid()}")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, rdv, q, kwargs, backend),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            try:
                rank, status, out = q.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise AssertionError(f"{world} ranks did not finish within "
                                     f"{timeout} s") from None
            if status != "ok":
                raise AssertionError(f"rank {rank} of {world} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


@contextlib.contextmanager
def single_rank_group(tmpdir: str):
    """A gloo process group of one rank, in this process."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(str(tmpdir), 'rdv_1')}",
        rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# What each rank computes for tests/test_torch_distributed.py
# ---------------------------------------------------------------------------
# Data is made with numpy from a seed, the same in the parent and in every
# rank; every result crosses back as numpy.

#: the sharded fits' configuration (the reference's own sharded tests')
SHARD_CFG = dict(m=16, t=32, silk_l=4, delta=5, k_max=64, pair_cap=8192)
#: the table-sync fits': k_max above k* so the budget does not bind
SYNC_CFG = dict(m=16, t=32, silk_l=4, delta=5, k_max=256, pair_cap=8192)
SYNC_RUNS = ((0, False), (2, False), (2, True))   # (refine_sweeps, compress)
N_FIT, N_NEW = 1537, 301                          # ragged at g = 2 and 4
STREAM_CHUNK = 256        # chunk= with mesh=: a multiple of g, ragged tail
KINDS = ("dense", "hetero", "sparse")


def blobs(kind: str, n: int, seed: int):
    """Raw parts with cluster structure: dense (n, 24) float32, hetero
    5 numeric + 4 categorical columns, sparse sets of 20 (ragged)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    k = 12
    lab = rng.integers(0, k, n)
    if kind == "dense":
        c = rng.standard_normal((k, 24))
        return ((c[lab] + 0.05 * rng.standard_normal((n, 24))
                 ).astype(np.float32),)
    if kind == "hetero":
        x_num = (rng.standard_normal((k, 5))[lab]
                 + 0.05 * rng.standard_normal((n, 5))).astype(np.float32)
        return x_num, rng.integers(0, 12, (k, 4))[lab].astype(np.int32)
    keep = rng.random((n, 20)) < 0.9
    sets = np.where(keep, rng.integers(0, 10**5, (k, 20))[lab],
                    rng.integers(0, 10**5, (n, 20))).astype(np.int32)
    mask = np.ones((n, 20), bool)
    mask[:, -4:] = rng.random((n, 4)) < 0.5
    return sets, mask


def exact_rows(n: int = 2000, d: int = 32, k: int = 16, seed: int = 0):
    """Rows with two nonzero entries, each a power of two (4 or 8), on a
    pair of dimensions per cluster: ``x @ a`` and every center sum are
    then exact, so two libraries that round differently agree."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    x = np.zeros((n, d), np.float32)
    r = np.arange(n)
    x[r, (2 * lab) % d] = 2.0 ** rng.integers(2, 4, n)
    x[r, (2 * lab + 1) % d] = 2.0 ** rng.integers(2, 4, n)
    return x


def collective_inputs(g: int):
    """Per-rank inputs of the collective tests: (g, 3, 50) float32 for
    ``compressed_psum`` and (g, 8, 4g) int32 values below 2**8, 2**16 and
    2**20 for ``narrow_int_all_to_all``."""
    import numpy as np
    rng = np.random.default_rng(g)
    x = rng.standard_normal((g, 3, 50)).astype(np.float32)
    ints = {b: rng.integers(0, 1 << b, (g, 8, 4 * g)).astype(np.int32)
            for b in (8, 16, 20)}
    return x, ints


def as_data(kind: str, parts):
    """The port's dataset spec of ``kind`` around raw ``parts``."""
    import repro_torch as rt
    return {"dense": rt.DenseData, "hetero": rt.HeteroData,
            "sparse": rt.SparseData}[kind](*parts)


def fit_outputs(est_cfg: dict, parts, kind: str, mesh=None, **kw):
    """(estimator, model, the fit's outputs as numpy): a CPU fit from
    seed 1, in-core without ``mesh``."""
    import repro_torch as rt
    est = rt.GEEK(rt.GeekConfig(**est_cfg), device="cpu")
    model = est.fit(as_data(kind, parts), 1, mesh=mesh, **kw)
    r = est.result_
    return est, model, dict(
        labels=r.labels.numpy(), dists=r.dists.numpy(),
        centers=model.centers.numpy(), valid=model.center_valid.numpy(),
        k_star=int(r.k_star), overflow=int(r.overflow),
        radius=model.radius.numpy(),
        seed_group=r.seeds.group.numpy(), seed_id=r.seeds.id.numpy(),
        seed_valid=r.seeds.valid.numpy(), impl=model.impl)


def spawned_outputs(rank: int, world: int, ckpt_dir: str, sync_path: str):
    """The spawn entry: ``{2: ..., world: ...}``, the outputs of
    ``mesh_outputs`` on a group of ranks 0 and 1 (ranks 0 and 1 only; it
    carries the table-sync runs, whose inputs it reads from the .npz at
    ``sync_path``) and on the whole world, so one spawn serves both world
    sizes."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.utils.compat import Mesh
    pair = dist.new_group([0, 1])
    out = {}
    if rank < 2:
        out[2] = mesh_outputs(Mesh(pair), ckpt_dir, dict(np.load(sync_path)))
    out[world] = mesh_outputs(Mesh(), ckpt_dir, None)
    return out


def mesh_outputs(mesh, ckpt_dir: str, sync: dict | None):
    """Everything the distributed tests compare, from one rank of
    ``mesh``. ``sync`` (when given) holds the reference's table-sync draws
    ``a`` and ``keys`` and the exact rows ``x``."""
    import warnings

    import torch
    import torch.distributed as dist

    import repro_torch as rt
    from repro_torch.distributed import compression
    rank, world = mesh.rank, mesh.size
    out = {}
    for kind in KINDS:
        parts = blobs(kind, N_FIT, 0)
        est, model, res = fit_outputs(SHARD_CFG, parts, kind, mesh)
        fresh = blobs(kind, N_NEW, 99)
        lab, dst = rt.make_predict_sharded(mesh)(model, *fresh)
        res["predict_fresh"] = (lab.numpy(), dst.numpy())
        lab, dst = rt.make_predict_sharded(mesh, probes=1)(model, *fresh)
        res["predict_probed"] = (lab.numpy(), dst.numpy())
        _, _, out[("streamed", kind)] = fit_outputs(SHARD_CFG, parts, kind,
                                                    mesh, chunk=STREAM_CHUNK)
        lab2, _ = est.predict(as_data(kind, fresh), mesh=mesh)
        res["predict_facade"] = lab2.numpy()
        # checkpoint of the sharded fit, restored on every rank, served
        path = f"{ckpt_dir}/{kind}_{world}"
        if rank == 0:
            rt.save_model(path, model)
        dist.barrier(group=mesh.group)
        back = rt.restore_model(path, mesh=mesh, device="cpu")
        res["restored_fit"] = rt.make_predict_sharded(mesh)(
            back, *parts)[0].numpy()
        out[("sharded", kind)] = res
        _, _, out[("gathered", kind)] = fit_outputs(SHARD_CFG, parts, kind, mesh,
                                             discovery="gathered")
    for kind in ("dense", "sparse"):
        _, _, out[("compress", kind)] = fit_outputs(
            dict(SHARD_CFG, compress_collectives=True), blobs(kind, N_FIT, 0),
            kind, mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, _, capped = fit_outputs(SHARD_CFG, blobs("dense", N_FIT, 0), "dense",
                            mesh, seed_cap=500)
    out["seed_cap"] = dict(capped, warned=[str(w.message) for w in caught])
    x, ints = collective_inputs(world)
    mean, resid = compression.compressed_psum(torch.from_numpy(x[rank]), mesh)
    out["compressed_psum"] = (mean.numpy(), resid.numpy())
    out["narrow"] = {b: compression.narrow_int_all_to_all(
        torch.from_numpy(v[rank]), mesh, 1 << b, split_axis=1,
        concat_axis=0).numpy() for b, v in ints.items()}
    tree = {"w": torch.from_numpy(x[rank][0]), "b": [torch.from_numpy(
        x[rank][1])]}
    means, _ = compression.compressed_psum_tree(tree, mesh)
    out["psum_tree"] = (means["w"].numpy(), means["b"][0].numpy())
    out["psum_leaves"] = tuple(compression.compressed_psum(
        torch.from_numpy(x[rank][i]), mesh)[0].numpy() for i in (0, 1))
    if sync is not None:
        out["sync"] = table_sync_runs(mesh, sync)
    return out


def table_sync_runs(mesh, sync: dict, runs=SYNC_RUNS) -> dict:
    """``make_fit_dense`` on the exact rows with the reference's draws, for
    each (refine_sweeps, compress_collectives) of ``runs``."""
    import torch

    import repro_torch as rt
    out = {}
    for sweeps, compress in runs:
        cfg = rt.GeekConfig(**SYNC_CFG, refine_sweeps=sweeps,
                            compress_collectives=compress)
        res = rt.make_fit_dense(mesh, cfg, device="cpu")(
            sync["x"], 0, a=torch.tensor(sync["a"]),
            table_keys=torch.tensor(sync["keys"].astype("int64")))
        out[(sweeps, compress)] = dict(
            labels=res.labels.numpy(), centers=res.centers.numpy(),
            valid=res.center_valid.numpy(), k_star=int(res.k_star),
            radius=res.radius.numpy(), overflow=int(res.overflow))
    return out


# ---------------------------------------------------------------------------
# What each rank computes for the mesh-serving tests (test_torch_serve.py)
# ---------------------------------------------------------------------------

#: request sizes rank 0 submits to a ``ClusterServer(mesh=)``
SERVE_SIZES = (1, 7, 16, 33, 64, 5, 40)


def serve_outputs(rank: int, world: int, ckpt_dir: str):
    """Every rank restores the port checkpoint at ``ckpt_dir`` and stands a
    ``ClusterServer(mesh=)`` up, exact and probed; rank 0 submits
    ``SERVE_SIZES`` requests of ``blobs("dense", ...)`` rows and returns
    each one's (offset, labels, dists, version); another rank returns
    whether its own ``submit`` raised ``NotLeaderError``."""
    import repro_torch as rt
    from repro_torch.serve import ClusterServer
    from repro_torch.serve.engine import NotLeaderError
    mesh = rt.make_mesh()
    model = rt.restore_model(ckpt_dir, mesh=mesh, device="cpu")
    (x,) = blobs("dense", sum(SERVE_SIZES), 7)
    out = {}
    for probes in (None, 1):
        server = ClusterServer(model, mesh=mesh, probes=probes, max_batch=64,
                               min_bucket=8, deadline_ms=2.0)
        if rank == 0:
            futs, off = [], 0
            for n in SERVE_SIZES:
                futs.append((off, server.submit(x[off:off + n])))
                off += n
            got = []
            for off, fut in futs:
                a = fut.result(timeout=120)
                got.append((off, a.labels, a.dists, a.version))
            out[probes] = dict(results=got, ladder=server.ladder,
                               stats=server.stats())
            server.close(timeout=120)
        else:
            try:
                server.submit(x[:1])
                refused = False
            except NotLeaderError:
                refused = True
            server.close(timeout=120)
            out[probes] = dict(refused=refused,
                               alive=server._worker.is_alive())
    return out


# ---------------------------------------------------------------------------
# What each rank computes for tests/test_torch_train.py
# ---------------------------------------------------------------------------

#: the ddp-compress trainer's arguments (Qwen3 smoke, float32)
DDP_ARGS = ["--device", "cpu", "--arch", "qwen3_0_6b", "--smoke",
            "--mode", "ddp-compress", "--steps", "2", "--batch", "4",
            "--seq", "32", "--lr", "1e-3", "--warmup", "1", "--log-every",
            "100"]


def ddp_train_outputs(rank: int, world: int):
    """This rank's ``launch.train --mode ddp-compress`` run of DDP_ARGS on
    the default (gloo) group: its losses, and its parameters, AdamW state
    and error-feedback residuals in the reference's layout (numpy; the
    residuals are kept in it)."""
    from repro_torch.launch import train as T
    from repro_torch.models.convert import params_to_numpy, tensor_to_numpy
    from repro_torch.utils.compat import make_mesh
    from repro_torch.utils.tree import tree_map
    args = T.build_parser().parse_args(DDP_ARGS)
    out = T.train(args, mesh=make_mesh(), log=lambda _: None)
    cfg = T.get_arch(args.arch, smoke=args.smoke)
    return {"losses": out["losses"],
            "params": params_to_numpy(out["params"], cfg),
            "state": {k: params_to_numpy(v, cfg)
                      for k, v in out["opt_state"].items()},
            "resid": tree_map(tensor_to_numpy, out["resid"])}


# ---------------------------------------------------------------------------
# What each rank computes for tests/test_torch_mesh_train.py
# ---------------------------------------------------------------------------
# The parent writes the reference's float32 Qwen3-smoke parameters, the
# batch and the MoE block's inputs (numpy, pickled) into ``work``; every
# result crosses back as numpy, rank 0's in full, the other ranks' shard
# ranges and cluster meshes only.

#: the mesh trainer's arguments (Qwen3 smoke, float32, constant-ish lr)
MESH_ARGS = ["--device", "cpu", "--arch", "qwen3_0_6b", "--smoke",
             "--steps", "2", "--batch", "4", "--seq", "32", "--lr", "1e-3",
             "--warmup", "1", "--log-every", "100", "--ckpt-every", "2"]
#: mesh-step steps held against the reference's
MESH_STEPS = 8
#: the smoke configs whose mesh step is held against the reference's as
#: well, each for the path it takes on the (2, 2) mesh: the attention's
#: q-group mode (Granite: 1 kv head, 4 q heads), its key-sequence mode
#: (SmolLM: 1 kv head, 3 q heads) and Mamba with the experts cut over
#: "model" (Jamba)
MODE_ARCHS = ("granite_34b", "smollm_360m", "jamba_v0_1_52b")
#: the MoE block's config: Jamba's smoke at capacity factor 0.5, so that
#: groups of 16 tokens drop pairs
MOE_CAPACITY = 0.5
MOE_B, MOE_S = 4, 8


def shard_ranges(tree, mesh, specs):
    """Per leaf of ``tree`` (tensors), this rank's shard under ``specs``
    on ``mesh`` as ``((start, stop), ...)`` per dim, read off a
    distributed ``arange`` (checked to be that box of it)."""
    import torch

    from repro_torch.launch import mesh as MESH
    from repro_torch.utils.tree import tree_map

    def one(spec, t):
        full = torch.arange(t.numel(), dtype=torch.int64).reshape(t.shape)
        local = MESH.distribute(full, mesh, spec).to_local()
        first = int(local.reshape(-1)[0]) if local.numel() else 0
        start, rem = [], first
        for n in reversed(t.shape):
            start.append(rem % n)
            rem //= n
        start = start[::-1]
        box = tuple((s, s + n) for s, n in zip(start, local.shape))
        assert torch.equal(local, full[tuple(slice(a, b) for a, b in box)])
        return box
    return tree_map(one, specs, tree, is_leaf=lambda s: isinstance(s, tuple))


def _load(work: str, name: str):
    import pickle
    with open(os.path.join(work, name), "rb") as f:
        return pickle.load(f)


def mesh_train_outputs(rank: int, world: int, work: str):
    """This rank's part of the mesh tests on a (2, 2) ("data", "model")
    gloo mesh: its shard ranges of every parameter (also on a (2, 1, 2)
    ("pod", "data", "model") mesh) and the indivisible dim's error; from
    rank 0 also the mesh step's step-1 loss and gradients, its
    ``MESH_STEPS`` losses and final parameters and AdamW state, the same
    of the single-process step, step 1's loss and gradients for each of
    ``MODE_ARCHS``, and the MoE block at dp = 2
    with its gradients (reference layout, numpy)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import moe as M
    from repro_torch.models import param_specs
    from repro_torch.models.convert import (params_from_numpy,
                                            params_to_numpy,
                                            specs_to_reference_layout,
                                            tensor_from_numpy,
                                            tensor_to_numpy,
                                            to_reference_layout)
    from repro_torch.models.sharding import P, activation_sharding, value
    from repro_torch.optim import adamw

    cfg = get_arch("qwen3_0_6b", smoke=True)
    mesh = MESH.make_test_mesh((2, 2), ("data", "model"))
    params = params_from_numpy(_load(work, "params.pkl"), cfg, "cpu")
    specs = param_specs(cfg)
    ref_specs = specs_to_reference_layout(specs, cfg)
    out = {"ranges": {}}
    for name, m in (("2x2", mesh), ("pod", MESH.make_test_mesh(
            (2, 1, 2), ("pod", "data", "model")))):
        box = shard_ranges(params, m, specs)
        # the reference's stacked leaves: the layers' boxes, behind the
        # stacking axis (whole)
        out["ranges"][name] = to_reference_layout(
            box, cfg, lambda bs: bs[0], lambda b: b)
    try:
        MESH.distribute(torch.zeros(3, 4), mesh, P("fsdp", "tp"))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    # the sharded fits' 1-axis meshes: every rank, then the first 2
    out["cluster"] = {}
    for n in (None, 2):
        m = MESH.make_cluster_mesh(n)
        if n is None or rank < n:
            out["cluster"][n] = (m.axis, m.size, m.rank, m.backend)

    def ref(tree):
        return params_to_numpy(tree, cfg)

    batch = {k: torch.from_numpy(v)
             for k, v in _load(work, "batch.pkl").items()}
    opt = adamw(1e-3)
    dparams, dstate = T.distribute_state(params, opt.init(params), cfg, opt,
                                         mesh)
    dbatch = T.distribute_batch(batch, mesh)
    with activation_sharding(mesh):
        loss, _, grads = loss_and_grads(cfg, dparams, dbatch)
    out["mesh"] = {"loss": float(value(loss)),
                   "grads": ref(MESH.full(grads))}
    loss, _, grads = loss_and_grads(cfg, params, batch)
    out["single"] = {"loss": float(loss), "grads": ref(grads)}
    for name, fn, p, s, b in (
            ("mesh", T.make_mesh_step(cfg, opt, mesh), dparams, dstate,
             dbatch),
            ("single", make_train_step(cfg, opt), params, opt.init(params),
             batch)):
        losses = []
        for step in range(MESH_STEPS):
            p, s, _, metrics = fn(p, s, step, b)
            losses.append(float(value(metrics["loss"])))
        out[name] |= {"losses": losses, "params": ref(MESH.full(p)),
                      "state": {k: ref(v) for k, v in
                                MESH.full(s).items()}}

    # the other attention modes, Mamba and the cut experts: step 1's loss
    # and gradients
    out["modes"] = {}
    for arch in MODE_ARCHS:
        acfg = get_arch(arch, smoke=True)
        ap = params_from_numpy(_load(work, f"params_{arch}.pkl"), acfg, "cpu")
        ab = T.distribute_batch({k: torch.from_numpy(v) for k, v in _load(
            work, f"batch_{arch}.pkl").items()}, mesh)
        with activation_sharding(mesh):
            loss, _, grads = loss_and_grads(
                acfg, MESH.distribute(ap, mesh, param_specs(acfg)), ab)
        mode = {"loss": float(value(loss)),
                "grads": params_to_numpy(MESH.full(grads), acfg)}
        out["modes"][arch] = mode

    # the MoE block at dp = 2 (groups of T / 2 tokens)
    mcfg = dataclasses.replace(get_arch("jamba_v0_1_52b", smoke=True),
                               moe_capacity_factor=MOE_CAPACITY)
    mp_, x, r = _load(work, "moe.pkl")
    mp_ = {k: tensor_from_numpy(v, "cpu") for k, v in mp_.items()}
    x, r = torch.from_numpy(x), torch.from_numpy(r)

    def moe_run(p, x, r):
        """The block's output, aux loss, drops, and the gradients of
        sum(y · r) + aux with respect to its weights and ``x``."""
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        x = x.detach().requires_grad_()
        y, aux = M.moe_apply(p, x, mcfg)
        ((y * r).sum() + aux).backward()
        grads = {k: tensor_to_numpy(value(v.grad)) for k, v in p.items()}
        return {"g": M.groups(MOE_B * MOE_S),
                "y": tensor_to_numpy(value(y).detach()),
                "aux": float(value(aux)),
                "dropped": int(value(M.dropped(mcfg, x, p))),
                "grads": grads | {"x": tensor_to_numpy(value(x.grad))}}
    with activation_sharding(mesh):
        out["moe"] = moe_run(MESH.distribute(mp_, mesh, M.moe_spec(mcfg)),
                             MESH.distribute(x, mesh, P("dp", None, None)),
                             MESH.distribute(r, mesh, P("dp", None, None)))
    out["moe_single"] = moe_run(mp_, x, r)
    out["specs"] = ref_specs
    # every rank takes part in every collective; rank 0 reports in full
    return out if rank == 0 else {k: out[k] for k in ("ranges", "cluster",
                                                      "indivisible")}


def mesh_checkpoint_outputs(rank: int, world: int, work: str):
    """On a (2, 2) gloo mesh: ``launch.train --mesh 2x2`` of MESH_ARGS
    writing ``work/ck_mesh``, and a ``--resume`` of the one-process
    checkpoint in ``work/ck_single`` (at its last step, so no step runs);
    rank 0 returns both runs' full parameters and AdamW state (reference
    layout, numpy)."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train as T
    from repro_torch.models.convert import params_to_numpy
    runs = {}
    for name, extra in (("wrote", ["--ckpt-dir", os.path.join(work,
                                                             "ck_mesh")]),
                        ("resumed", ["--ckpt-dir", os.path.join(
                            work, "ck_single"), "--resume"])):
        args = T.build_parser().parse_args(MESH_ARGS + ["--mesh", "2x2"]
                                           + extra)
        got = T.train(args, log=lambda _: None)
        cfg = T.get_arch(args.arch, smoke=args.smoke)
        full = (MESH.full(got["params"]), MESH.full(got["opt_state"]))
        runs[name] = {"step": got["step"],
                      "params": params_to_numpy(full[0], cfg),
                      "state": {k: params_to_numpy(v, cfg)
                                for k, v in full[1].items()}}
    return runs if rank == 0 else None


#: the smoke configs of the four-card mesh step: each attention score mode
#: on a (2, 2) mesh (kv heads, q groups, the key sequence), Mamba, and the
#: experts cut over "model"
CARD_MESH_ARCHS = ("qwen3_0_6b", "granite_34b", "smollm_360m",
                   "jamba_v0_1_52b", "kimi_k2_1t_a32b")


def mesh_card_outputs(rank: int, world: int):
    """On a (2, 2) ("data", "model") NCCL mesh of four cards: step 1's loss
    and gradients of the mesh step of each of ``CARD_MESH_ARCHS`` (float32
    smoke, batch 4 x 32) and of the same step on this rank's card alone,
    the MoE dispatch cut into the mesh's groups (g = gcd(T, 2)) there too;
    rank 0 returns ``{arch: (mesh loss, card loss, the largest gradient
    gap over its leaf's largest magnitude)}``."""
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params, param_specs
    from repro_torch.models import moe as M
    from repro_torch.models.sharding import activation_sharding, value
    from repro_torch.utils.tree import tree_leaves, tree_map

    dev = torch.device("cuda", rank)
    mesh = MESH.make_test_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in CARD_MESH_ARCHS:
        cfg = get_arch(arch, smoke=True)
        params = tree_map(lambda t: t.to(dev),
                          init_params(cfg, 0, device="cpu"))
        gen = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                                  dtype=torch.int32).to(dev)
                 for k in ("inputs", "labels")}
        with activation_sharding(mesh):
            loss, _, grads = loss_and_grads(
                cfg, MESH.distribute(params, mesh, param_specs(cfg)),
                T.distribute_batch(batch, mesh))
        grads = tree_leaves(MESH.full(grads))
        groups = M.groups
        M.groups = lambda t: math.gcd(t, 2)
        try:
            one, _, want = loss_and_grads(cfg, params, batch)
        finally:
            M.groups = groups
        worst = max(float((g - w).abs().max() / w.abs().max().clamp(
            min=1e-30)) for g, w in zip(grads, tree_leaves(want)))
        out[arch] = (float(value(loss)), float(one), worst)
    return out if rank == 0 else None
