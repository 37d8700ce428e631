"""Fault-tolerant training driver (the counterpart of ``repro.launch.train``).

Two execution modes:
  pjit (default)   the mesh-sharded train step: parameters, optimizer
                   state and batch are DTensors cut by their logical
                   specs (``models.param_specs``, ``state_specs``, the
                   batch over "dp") on a ``(data, model)`` DeviceMesh
                   (``--mesh AxB``; else a 1-D ``("data",)`` mesh over
                   every rank), and ``launch.steps.make_train_step`` runs
                   on them under ``models.sharding.activation_sharding``.
                   One process with no ``--mesh`` runs the same step on
                   plain tensors (the single-card step).
  ddp-compress     data parallel over the ranks of a ``torch.distributed``
                   group (NCCL on cards, gloo on the CPU), each rank on
                   its rows of the global batch, with the int8 all-reduce
                   of the gradients and error feedback
                   (``distributed.compression.compressed_psum_tree``)

A mesh must have as many ranks as the process group: the reference takes
the first devices of a larger set, the port raises and names both.

Fault tolerance: atomic async checkpoints every ``--ckpt-every`` steps,
exact resume (``--resume``: parameters, optimizer state and step; the
data pipeline is a pure function of the step), so a preempted job
continues bit for bit. Checkpoints hold ``(params, opt_state)`` in the
reference's layout (``models.convert.params_to_numpy``: layers stacked
over the periods of the layer plan), so either package resumes the
other's. They are topology-free: a mesh run writes the full tensors
(gathered; rank 0 writes) and a restore cuts them onto whatever mesh the
restart has. ``--ddp-compress`` does not checkpoint its error-feedback
residuals, as the reference does not.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3_0_6b --smoke --steps 20 --ckpt-dir /tmp/ckpt --ckpt-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --seq 4096 --batch 8 --grad-accum 2 --steps 8     # on the card
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --mode ddp-compress --arch qwen3_0_6b --smoke
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --mesh 2x2 --arch qwen3_0_6b --smoke
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.tokens import EmbeddingPipeline, TokenPipeline
from repro_torch.distributed.compression import compressed_psum_tree
from repro_torch.launch import mesh as MESH
from repro_torch.launch.steps import (abstract_params, loss_and_grads,
                                      make_train_step)
from repro_torch.models import init_params, param_specs
from repro_torch.models import model as MODEL
from repro_torch.models.convert import (from_reference_layout,
                                        params_from_numpy, params_to_numpy,
                                        to_reference_layout)
from repro_torch.models.sharding import P, activation_sharding, value
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine
from repro_torch.utils import compat
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def make_pipeline(cfg, batch, seq, seed):
    if MODEL.has_token_embed(cfg):
        return TokenPipeline(vocab_size=cfg.vocab_size, batch=batch,
                             seq_len=seq, seed=seed)
    return EmbeddingPipeline(d_model=cfg.d_model, vocab_size=cfg.vocab_size,
                             batch=batch, seq_len=seq, seed=seed)


def to_checkpoint(params, opt_state, cfg):
    """``(params, opt_state)`` in the reference's layout, numpy leaves."""
    return (params_to_numpy(params, cfg),
            {k: params_to_numpy(v, cfg) for k, v in opt_state.items()})


def checkpoint_target(params, opt_state, cfg):
    """The structure of ``to_checkpoint``'s tree (leaves unused)."""
    def layout(tree):
        return to_reference_layout(tree, cfg, lambda _: 0, lambda _: 0)
    return layout(params), {k: layout(v) for k, v in opt_state.items()}


def from_checkpoint(tree, cfg, device):
    """``to_checkpoint``'s tree back as the port's ``(params, opt_state)``
    on ``device``."""
    params, state = tree
    return (params_from_numpy(params, cfg, device),
            {k: params_from_numpy(v, cfg, device) for k, v in state.items()})


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches a step (pjit mode)")
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 = data x model")
    ap.add_argument("--mode", default="pjit", choices=["pjit", "ddp-compress"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises without a card)")
    return ap


def build_mesh(spec: str | None, device):
    """The pjit mode's DeviceMesh over the default process group: ``AxB``
    over ``("data", "model")`` (``A`` over ``("data",)``), or with no
    spec a 1-D ``("data",)`` mesh over every rank. Raises unless the
    mesh has as many ranks as the group and the group's backend is the
    device's."""
    import torch.distributed as dist
    world = dist.get_world_size()
    shape = (world,) if spec is None else tuple(
        int(p) for p in spec.split("x"))
    names = ("data", "model")[:len(shape)]
    if len(shape) > 2 or math.prod(shape) != world:
        raise ValueError(f"--mesh {spec} is {math.prod(shape)} ranks over "
                         f"{names}; the process group has {world}")
    compat.check_device(compat.make_mesh(), device)
    return MESH.make_test_mesh(shape, names)


def distribute_state(params, opt_state, cfg, opt, mesh):
    """``(params, opt_state)`` (full tensors, the same on every rank) as
    DTensors cut by ``param_specs`` and the optimizer's ``state_specs``."""
    specs = param_specs(cfg)
    return (MESH.distribute(params, mesh, specs),
            MESH.distribute(opt_state, mesh,
                            opt.state_specs(specs, abstract_params(cfg))))


def distribute_batch(batch, mesh):
    """A global batch (the same on every rank) cut over "dp" by rows."""
    return {k: MESH.distribute(v, mesh, P("dp")) for k, v in batch.items()}


def make_mesh_step(cfg, opt, mesh, grad_accum: int = 1):
    """``make_train_step``'s step on DTensors under
    ``activation_sharding(mesh)``: the same function, its tensors cut."""
    fn = make_train_step(cfg, opt, grad_accum=grad_accum)

    def mesh_step(params, opt_state, step, batch):
        with activation_sharding(mesh):
            return fn(params, opt_state, step, batch)
    return mesh_step


def make_ddp_step(cfg, opt, mesh):
    """The reference's ``ddp_step`` body on this rank: its rows' loss and
    gradients plus the residual, the int8 mean over the ranks, the mean
    loss, clipping and the update. Returns ``(params, opt_state, resid,
    loss, grad_norm)``.

    The int8 mean scales each tensor by its largest magnitude, so which
    elements share a scale is part of its result: the gradients are
    quantized leaf by leaf of the reference's layout (each period
    position's layers stacked, ``models.convert.to_reference_layout``),
    and the residuals (float32) are kept in that layout."""
    def ddp_step(params, opt_state, resid, step, batch):
        loss, _, grads = loss_and_grads(cfg, params, batch)
        grads = to_reference_layout(grads, cfg, torch.stack, lambda g: g)
        grads = tree_map(lambda g, r: g.to(torch.float32) + r, grads, resid)
        grads, new_resid = compressed_psum_tree(grads, mesh)
        grads = from_reference_layout(grads, cfg, lambda g: g)
        loss = compat.psum(loss, mesh) / compat.axis_size(mesh)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        new_params, new_state = opt.update(grads, opt_state, params, step)
        return new_params, new_state, new_resid, loss, gnorm
    return ddp_step


def ddp_residuals(params, cfg):
    """The ddp-compress step's first error-feedback residuals: float32
    zeros shaped as ``params`` in the reference's layout."""
    return to_reference_layout(
        params, cfg, lambda ps: torch.zeros(
            (len(ps),) + tuple(ps[0].shape), dtype=torch.float32,
            device=ps[0].device),
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device))


@contextlib.contextmanager
def _process_group(device):
    """The default process group: the one already started (by the caller
    or ``torchrun``'s environment), else a group of one rank on a file
    store in a temporary directory, closed on leaving."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    backend = compat.BACKENDS[device.type]
    if "RANK" in os.environ:
        dist.init_process_group(backend)
        try:
            yield
        finally:
            dist.destroy_process_group()
        return
    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group(backend, init_method=f"file://{rdv}/rdv",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _uses_mesh(args, mesh) -> bool:
    """Whether a pjit run takes the mesh step: a mesh given or asked for,
    or a process group of more than one rank."""
    import torch.distributed as dist
    return args.mode == "pjit" and (
        mesh is not None or args.mesh is not None
        or (dist.is_initialized() and dist.get_world_size() > 1))


def train(args, *, params=None, mesh=None, stop: int | None = None,
          log=print) -> dict:
    """Run ``args`` (``build_parser``'s) and return ``{"params",
    "opt_state", "step", "losses", "step_seconds", "save_seconds"}`` (and
    ``"grad_norms"`` in pjit mode, ``"resid"``, in the reference's
    layout, in ddp-compress mode; a mesh run returns DTensors).
    ``params``: the starting weights (the port's tree, on the run's
    device, the same on every rank) in place of the draw from ``--seed``
    (a draw differs between the card's and the CPU's generators); a
    ``--resume`` that finds a checkpoint replaces them. ``mesh``: the
    pjit mode's DeviceMesh (default ``build_mesh`` of ``--mesh``), or the
    ddp-compress mode's ``utils.compat.Mesh`` (the default group when not
    given). ``stop`` ends the loop after that
    step, as a preempted job would, without changing the schedule (which
    runs to ``--steps``)."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    pipe = make_pipeline(cfg, args.batch, args.seq, args.seed)
    opt = adamw(warmup_cosine(args.lr, args.warmup, args.steps))

    if params is None:
        params = init_params(cfg, args.seed, device=device)
    opt_state = opt.init(params)
    start_step = 0
    rank, world = 0, 1
    if args.mode == "ddp-compress":
        mesh = mesh if mesh is not None else compat.make_mesh()
        compat.check_device(mesh, device)
        rank, world = mesh.rank, mesh.size
        if args.batch % world:
            raise ValueError(f"--batch {args.batch} is not a multiple of "
                             f"{world} ranks")
    elif _uses_mesh(args, mesh):
        if mesh is None:
            mesh = build_mesh(args.mesh, device)
        rank = mesh.get_rank()
    else:
        mesh = None

    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if cm and args.resume and cm.latest_step() is not None:
        tree, start_step = cm.restore(checkpoint_target(params, opt_state,
                                                        cfg))
        del params, opt_state
        params, opt_state = from_checkpoint(tree, cfg, device)
        del tree
        log(f"[train] resumed from step {start_step}")

    if args.mode == "pjit" and mesh is not None:
        params, opt_state = distribute_state(params, opt_state, cfg, opt,
                                             mesh)
        fn = make_mesh_step(cfg, opt, mesh, grad_accum=args.grad_accum)
    elif args.mode == "pjit":
        fn = make_train_step(cfg, opt, grad_accum=args.grad_accum)
    else:
        fn = make_ddp_step(cfg, opt, mesh)
        resid = ddp_residuals(params, cfg)
        rows = args.batch // world

    losses, grad_norms, step_seconds, save_seconds = [], [], [], []
    t0 = time.time()
    step = start_step
    end = args.steps if stop is None else min(stop, args.steps)
    loss = float("nan")
    try:
        while step < end:
            ts = time.perf_counter()
            batch = {k: v.to(device)
                     for k, v in pipe.global_batch(step).items()}
            if args.mode == "pjit":
                if mesh is not None:
                    batch = distribute_batch(batch, mesh)
                params, opt_state, _, metrics = fn(params, opt_state, step,
                                                   batch)
                loss = float(value(metrics["loss"]))
                grad_norms.append(float(value(metrics["grad_norm"])))
            else:
                local = {k: v[rank * rows:(rank + 1) * rows]
                         for k, v in batch.items()}
                params, opt_state, resid, loss_t, _ = fn(
                    params, opt_state, resid, step, local)
                loss = float(loss_t)
            step_seconds.append(time.perf_counter() - ts)
            losses.append(loss)
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                dt = (time.time() - t0) / max(step - start_step, 1)
                log(f"[train] step {step:5d} loss {loss:.4f} "
                    f"{dt*1e3:.0f} ms/step")
            if cm and (step % args.ckpt_every == 0 or step == args.steps):
                ts = time.perf_counter()
                whole = (params, opt_state)
                if args.mode == "pjit" and mesh is not None:
                    whole = (MESH.full(params), MESH.full(opt_state))
                if rank == 0:
                    cm.save(step, to_checkpoint(*whole, cfg), wait=False)
                    save_seconds.append(time.perf_counter() - ts)
                del whole
    finally:
        if cm:
            cm.wait_for_save()
    log(f"[train] done at step {step}; final loss {loss:.4f}")
    out = {"params": params, "opt_state": opt_state, "step": step,
           "losses": losses, "step_seconds": step_seconds,
           "save_seconds": save_seconds}
    if args.mode == "ddp-compress":
        out["resid"] = resid
    else:
        out["grad_norms"] = grad_norms
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "ddp-compress" or args.mesh is not None \
            or "RANK" in os.environ:
        device = resolve_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        with _process_group(device):
            import torch.distributed as dist
            # one log for the job: every rank runs the same steps
            train(args, log=print if dist.get_rank() == 0
                  else (lambda _: None))
    else:
        train(args)


if __name__ == "__main__":
    main()
