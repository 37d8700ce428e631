"""Production meshes and logical-axis resolution (the counterpart of
``repro.launch.mesh``), on ``torch.distributed``'s ``DeviceMesh``.

Everything is a function: importing this module starts no process group.
The meshes are built over the default process group, which the caller
starts (``init_process_group`` with its address, world size and rank, or
``torchrun``); their device type follows its backend (NCCL: ``cuda``,
gloo: ``cpu``).

Logical axis names used by the model's and the optimizer's specs:
    dp   -> batch            ("pod","data")
    fsdp -> parameter shards ("pod","data")   (ZeRO-3)
    tp   -> tensor/expert    ("model",)
    sp   -> sequence (KV)    ("model",)

A resolved spec becomes DTensor placements, one per mesh dim:
``Shard(d)`` on every mesh dim of more than one rank that the entry for
tensor dim ``d`` names, ``Replicate()`` elsewhere: a dim of one rank
cuts nothing, and DTensor's view rules refuse some reshapes of a dim
cut over one rank. A spec shorter than the tensor leaves its
trailing dims replicated. Two of JAX's rules are kept: a dim cut over
two mesh axes (``("pod","data")``) is cut major to minor in the entry's
order, as ``NamedSharding`` cuts it (DTensor cuts in mesh-dim order, so
an entry out of that order raises); and a dim that its mesh axes do not
divide raises ``ValueError``, as ``jax.device_put`` does, where DTensor
would cut it unevenly.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.sharding import P, is_spec
from repro_torch.utils import compat
from repro_torch.utils.tree import tree_map

_DEVICE_TYPES = {backend: dev for dev, backend in compat.BACKENDS.items()}


def _device_type() -> str:
    """The device type of the default process group's backend."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialized torch.distributed "
                           "process group (init_process_group or torchrun)")
    return _DEVICE_TYPES.get(str(dist.get_backend()).lower(), "cpu")


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the default group (every rank calls it)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    return DeviceMesh(_device_type(), torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) over ("data","model"), or (2, 16, 16) over
    ("pod","data","model"): 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes)


def make_cluster_mesh(num_devices: int | None = None):
    """The 1-axis mesh of the sharded GEEK fits (the paper's g processes):
    ``utils.compat.Mesh`` over the default group, or over a group of its
    first ``num_devices`` ranks (every rank calls it; the others get a
    mesh they do not belong to)."""
    import torch.distributed as dist
    _device_type()
    if num_devices is None or num_devices == dist.get_world_size():
        return compat.make_mesh()
    return compat.Mesh(dist.new_group(ranks=list(range(num_devices))))


def axis_names(mesh) -> tuple:
    """A mesh's axis names (a ``DeviceMesh``'s ``mesh_dim_names``, or an
    ``axis_names`` attribute)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _logical_map(mesh) -> dict:
    names = axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    return {"dp": dp, "fsdp": dp, "tp": tp, "sp": tp}


def resolve_spec(spec, mesh, *, drop: tuple[str, ...] = ()) -> P:
    """Map logical axis names in a spec to concrete mesh axes. Logical
    axes in ``drop`` (e.g. "dp" for batch-1 decode) become None; names
    that are not logical pass through."""
    m = dict(_logical_map(mesh))
    for a in drop:
        m[a] = ()
    out = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
            continue
        parts = entry if isinstance(entry, tuple) else (entry,)
        concrete: list[str] = []
        for a in parts:
            concrete.extend(m.get(a, (a,)))
        if not concrete:
            out.append(None)
        else:
            out.append(concrete[0] if len(concrete) == 1 else tuple(concrete))
    return P(*out)


def placements(spec, mesh, shape=None, *, drop: tuple[str, ...] = ()):
    """The DTensor placements (a tuple, one per mesh dim) of a logical
    spec on ``mesh``. With ``shape``, a dim that its mesh axes do not
    divide raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate()] * len(names)
    resolved = resolve_spec(spec, mesh, drop=drop)
    if shape is not None and len(resolved) > len(shape):
        raise ValueError(f"spec {resolved} has more entries than a tensor "
                         f"of shape {tuple(shape)} has dims")
    for d, entry in enumerate(resolved):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh {names} has no axis {a!r}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} used twice in {resolved}")
            dims.append(names.index(a))
        if dims != sorted(dims):
            raise ValueError(f"entry {entry} is not in the mesh's axis "
                             f"order {names}")
        n = math.prod(sizes[a] for a in axes)
        if shape is not None and shape[d] % n:
            raise ValueError(f"dim {d} of shape {tuple(shape)} does not "
                             f"divide over mesh axes {axes} ({n} ranks)")
        for i in dims:
            if mesh.shape[i] > 1:   # a dim of one rank cuts nothing
                out[i] = Shard(d)
    return tuple(out)


def local_shape(spec, mesh, shape, *, drop: tuple[str, ...] = ()):
    """The shape of one rank's shard of a tensor of ``shape`` cut by
    ``spec`` on ``mesh`` (every dim divides, or ``placements`` raises)."""
    out = list(shape)
    for size, pl in zip(mesh.shape, placements(spec, mesh, shape,
                                               drop=drop)):
        if hasattr(pl, "dim"):
            out[pl.dim] //= size
    return tuple(out)


def shardings_for_dropped(tree_specs, mesh, drop: tuple[str, ...]):
    """A tree of logical specs -> the tree of their placements, with the
    logical axes in ``drop`` un-sharded."""
    return tree_map(lambda s: placements(s, mesh, drop=drop), tree_specs,
                    is_leaf=is_spec)


def shardings_for(tree_specs, mesh):
    """A tree of logical specs -> the tree of their placements."""
    return shardings_for_dropped(tree_specs, mesh, ())


def replicated(mesh):
    """The placements of a tensor whole on every rank."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def distribute(tree, mesh, specs):
    """A tree of full tensors (the same on every rank) as DTensors cut by
    ``specs`` (logical specs, or ``None`` for replicated), each rank
    keeping its shard. Indivisible dims raise ``ValueError``."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, spec):
        pl = placements(spec, mesh, t.shape) if spec is not None \
            else replicated(mesh)
        return distribute_tensor(t, mesh, list(pl))
    if specs is None:
        return tree_map(lambda t: put(t, None), tree)
    return tree_map(lambda s, t: put(t, s), specs, tree, is_leaf=is_spec)


def full(tree):
    """A tree of DTensors as full tensors on every rank (an all-gather of
    each leaf; every rank calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)
