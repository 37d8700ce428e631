"""Meshes over ``torch.distributed`` process groups, and the collectives
the sharded bodies use.

The counterpart of ``repro.utils.compat.make_mesh`` and of the
``jax.lax`` collectives that ``repro``'s ``shard_map`` bodies call. A
``Mesh`` names a process group (the default group unless told otherwise)
and its one data-parallel axis (``"data"``, the repository's
convention). Every rank runs the same program on its own rows; the
helpers below are what the per-device bodies of ``repro`` reach through
``jax.lax``: ``axis_index``, ``axis_size``, tiled ``all_to_all``,
``all_gather``, ``psum`` and ``pmax``.

The backend follows the device: NCCL for ``cuda`` tensors, gloo for the
CPU. ``check_device`` refuses a mismatch; there is no silent CPU path for
a card's mesh. The caller initializes the process group
(``torch.distributed.init_process_group``, or ``torchrun``), giving its
address, world size and rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

#: the backend each device type takes
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of ranks: a process group (``None`` is the default one)."""

    group: Any = None
    axis: str = "data"

    @property
    def size(self) -> int:
        """Ranks on the axis (``jax.lax.axis_size``)."""
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This rank's index on the axis (``jax.lax.axis_index``)."""
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        """``"nccl"`` or ``"gloo"``."""
        return str(dist.get_backend(self.group)).lower()


def make_mesh(axis: str = "data", group=None) -> Mesh:
    """The 1-axis mesh over ``group`` (default: the default process group).

    Raises when ``torch.distributed`` is not initialized: the caller
    starts the group (``init_process_group`` with its address, world size
    and rank, or ``torchrun``).
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (init_process_group or torchrun)")
    return Mesh(group, axis)


def check_device(mesh: Mesh, device: torch.device, axis: str | None = None
                 ) -> None:
    """Raise unless ``mesh``'s backend is the one for ``device`` (NCCL for
    ``cuda``, gloo for the CPU) and ``axis`` (when given) is its axis."""
    want = BACKENDS[torch.device(device).type]
    if mesh.backend != want:
        raise ValueError(f"a {torch.device(device).type} estimator needs a "
                         f"{want} mesh, got {mesh.backend}")
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")


def axis_index(mesh: Mesh) -> int:
    """This rank's position on the axis."""
    return mesh.rank


def axis_size(mesh: Mesh) -> int:
    """The number of ranks on the axis."""
    return mesh.size


# torch.distributed takes no bool, and gloo no 16-bit integer, so those
# cross as bytes of the same bits
_AS_BYTES = (torch.bool, torch.int16, torch.uint16)


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype in _AS_BYTES else x


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(g, *x.shape): every rank's ``x`` stacked in rank order
    (``jax.lax.all_gather``)."""
    w = _wire(x)
    out = torch.empty((mesh.size,) + tuple(w.shape), dtype=w.dtype,
                      device=w.device)
    dist.all_gather(list(out.unbind(0)), w, group=mesh.group)
    return out.view(x.dtype) if x.dtype in _AS_BYTES else out


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over ranks (``jax.lax.psum``); a new tensor."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    return y


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Maximum over ranks (``jax.lax.pmax``); a new tensor."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group)
    return y


def all_to_all(x: torch.Tensor, mesh: Mesh, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled ``jax.lax.all_to_all``: ``x`` is cut into g equal blocks
    along ``split_axis``; rank j receives block j of every rank and
    concatenates them, in rank order, along ``concat_axis``.

    ``all_to_all_single`` moves blocks along dim 0 only, so the blocks are
    stacked in front first (a contiguous copy) and laid out again after.
    The caller pads ``split_axis`` to a multiple of g.
    """
    g = mesh.size
    if x.shape[split_axis] % g:
        raise ValueError(f"split axis of size {x.shape[split_axis]} does not "
                         f"divide over {g} ranks")
    send = torch.stack(torch.chunk(x, g, dim=split_axis))   # (g, *block)
    w = _wire(send)
    recv = torch.empty_like(w)
    dist.all_to_all_single(recv, w, group=mesh.group)
    if x.dtype in _AS_BYTES:
        recv = recv.view(x.dtype)
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)
