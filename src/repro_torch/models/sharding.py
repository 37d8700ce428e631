"""Activation sharding constraints with logical axis names (the
counterpart of ``repro.models.sharding``).

The model code stays mesh-agnostic: ``constrain(x, "dp", None, "tp")``
names one logical entry per dim, resolved against the mesh installed by
``activation_sharding(mesh)`` (``launch.mesh.resolve_spec``; the trainer's
mesh mode installs it). Under a mesh the model's tensors are DTensors
(``torch.distributed.tensor``) and ``constrain`` redistributes its
argument to the placements the spec resolves to, where the reference's
``with_sharding_constraint`` pins XLA's layout. With no active mesh (every
single-card path: the decode step's CUDA graph, the fits, the tests) it
returns its argument itself and does no other work.

``P`` is the port's PartitionSpec: a tuple of entries, each a logical (or
mesh) axis name, a tuple of names, or ``None``. It equals the tuple of
its entries, so a tree of ``P`` compares with ``tuple(jax_spec)``.
"""
from __future__ import annotations

import contextlib

_ACTIVE: list = []


class P(tuple):
    """A PartitionSpec: ``P("fsdp", "tp")``, ``P(("pod", "data"), None)``,
    ``P()`` (replicated). Trailing dims a spec does not name are
    replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def is_spec(x) -> bool:
    """Whether ``x`` is a leaf of a spec tree."""
    return isinstance(x, P)


@contextlib.contextmanager
def activation_sharding(mesh, drop: tuple[str, ...] = ()):
    """Install ``mesh`` (a ``DeviceMesh``) for ``constrain``, ``tp_size``
    and ``dp_size``. drop: logical axes to un-shard (e.g. ("dp",) for
    batch-1 long-context decode, where the batch axis cannot be cut).
    Plain tensors that meet DTensors inside count as replicated
    (``implicit_replication``): the model builds only constants that are
    the same on every rank (masks, positions, zeros)."""
    from torch.distributed.tensor.experimental import implicit_replication
    _ACTIVE.append((mesh, tuple(drop)))
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE.pop()


def constrain(x, *axes):
    """axes: one logical entry per dim ('dp' | 'tp' | 'sp' | 'fsdp' |
    None). No mesh: ``x`` itself. Under a mesh a DTensor is redistributed
    to the resolved placements (its autograd follows); a plain tensor is
    this rank's own value and is returned as it is."""
    if not _ACTIVE:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, drop = _ACTIVE[-1]
    from repro_torch.launch.mesh import placements
    want = placements(P(*axes), mesh, x.shape, drop=drop)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def placed(*axes, summed=()):
    """The placements on the active mesh of a tensor cut by ``axes`` (one
    logical entry per dim, as ``constrain`` takes them), with
    ``Partial()`` on the mesh dims of the logical axes in ``summed``:
    each rank holds its share of the value, summed over those dims. A
    list, as ``local`` takes one output's; ``None`` with no mesh
    (``local`` then ignores it)."""
    if not _ACTIVE:
        return None
    from torch.distributed.tensor import Partial
    from repro_torch.launch.mesh import placements, resolve_spec
    mesh, drop = _ACTIVE[-1]
    out = list(placements(P(*axes), mesh, drop=drop))
    for entry in resolve_spec(P(*summed), mesh, drop=drop):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[mesh.mesh_dim_names.index(a)] = Partial()
    return out


def local(fn, *args, out, ins, grads=None):
    """``fn(*args)`` on this rank's shards (torch's ``local_map``), for
    work DTensor has no sharding rule for: each DTensor of ``args`` is
    redistributed to its entry of ``ins`` (``placed``'s placements;
    ``None`` for an argument that is not a tensor) and passes as its
    local tensor, its gradient placed on the way back as its entry of
    ``grads`` (default ``ins``; ``Partial`` where each rank's ``fn``
    sees only its share of the work that argument feeds). The result is
    a DTensor placed as ``out`` (a tuple of them for a tuple of
    results). With no mesh, ``fn(*args)``."""
    if not _ACTIVE:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads or ins,
                     device_mesh=_ACTIVE[-1][0],
                     redistribute_inputs=True)(*args)


def value(x):
    """A DTensor's full value on every rank (every rank calls it);
    anything else as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _sizes() -> dict:
    mesh = _ACTIVE[-1][0]
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def tp_rank() -> int:
    """This rank's index on the active mesh's "model" axis (0 if none)."""
    if not _ACTIVE or tp_size() == 1:
        return 0
    return _ACTIVE[-1][0].get_local_rank("model")


def tp_group():
    """The process group of the active mesh's "model" axis."""
    return _ACTIVE[-1][0].get_group("model")


def tp_size() -> int:
    """Size of the tensor-parallel axis of the active mesh (1 if none):
    lets the model pick a divisible sharding dim (kv heads, q groups or
    the key sequence for attention scores)."""
    if not _ACTIVE:
        return 1
    return _sizes().get("model", 1)


def dp_size() -> int:
    """Total size of the batch axes of the active mesh (1 if none, or if
    "dp" is dropped)."""
    if not _ACTIVE:
        return 1
    if "dp" in _ACTIVE[-1][1]:
        return 1
    sizes = _sizes()
    return sizes.get("pod", 1) * sizes.get("data", 1)
