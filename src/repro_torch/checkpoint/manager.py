"""Checkpoints in the reference's format, with no JAX: the
``CheckpointManager`` of training states, and GeekModel save/restore on
top of it.

The counterpart of ``repro.checkpoint.manager``. A checkpoint directory
holds ``step_<8 digits>/`` with one ``leaf_<5 digits>.npy`` per array and
a ``manifest.json`` (``{"step", "treedef", "extra", "leaves"}``, each
leaf's file, shape and dtype). Leaves are numbered in JAX's flatten
order (``utils.tree``: dict keys sorted, lists and tuples in order), so
either package restores the other's trees. A step is written into
``tmp.<step>`` and renamed into place only when complete, so a crash
never leaves a half-written step; ``keep`` most recent steps are kept.

bfloat16 leaves are written as the reference writes them (``np.save`` of
an ``ml_dtypes`` array: a ``'<V2'`` header and the raw words, with
``"bfloat16"`` in the manifest) and read back by the manifest's dtype.
The reference's own restore returns them as raw ``|V2`` arrays, which
JAX refuses (ROADMAP.md, Queue 3, "Not port faults").

``save_model`` / ``restore_model`` persist a fitted ``GeekModel``: leaf
*i* is the *i*-th name of ``extra["fields"]`` (the reference stores
``sorted(arrays)``). ``model_from_numpy`` carries state across: host
arrays + manifest metadata -> a ``GeekModel`` on a device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core import model as model_mod
from repro_torch.core import transform as transform_mod
from repro_torch.models.convert import BF16_WORDS, tensor_from_numpy, \
    tensor_to_numpy
from repro_torch.utils import compat
from repro_torch.utils.device import resolve_device
from repro_torch.utils.hashing import derive_hash_keys_from_key
from repro_torch.utils.tree import tree_flatten, tree_unflatten, treedef_str

#: dtypes of the canonical leaves, as the reference writes them; centers
#: are float32 centroids for l2 and int32 mode codes for hamming
_LEAF_DTYPES = {"center_valid": np.bool_, "k_star": np.int32,
                "radius": np.float32}
_CENTER_DTYPES = {"l2": (np.float32, torch.float32),
                  "hamming": (np.int32, torch.int32)}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _snapshot(leaf) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a leaf: a tensor, a numpy array or
    a scalar; bfloat16 (a tensor, an ``ml_dtypes`` array, or raw ``V2``
    words) as its raw words, named ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        leaf = tensor_to_numpy(leaf)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_WORDS:
        return np.ascontiguousarray(a).view(BF16_WORDS), "bfloat16"
    return a, str(a.dtype)


def _save_leaf(path: str, a: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, a)
        return
    with open(path, "wb") as fh:              # what np.save writes for bf16
        np.lib.format.write_array_header_1_0(
            fh, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        fh.write(a.tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    """A leaf file read by its manifest dtype, as a CPU tensor."""
    a = np.load(path)
    if dtype == "bfloat16":
        return tensor_from_numpy(a.view(BF16_WORDS), "cpu")
    return torch.from_numpy(a)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _latest_step(directory: str) -> int:
    """The newest step in ``directory``; raises when there is none."""
    step = CheckpointManager(directory, create=False).latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return step


class CheckpointManager:
    """Atomic, async checkpoints of a tree of tensors (or numpy arrays)
    in the reference's format, with ``keep`` most recent steps retained.
    ``create=False`` for read-only use: probing a path must not make it."""

    def __init__(self, directory: str, *, keep: int = 3,
                 create: bool = True):
        self.dir = directory
        self.keep = keep
        if create:
            os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, *, wait: bool = True,
             extra: dict | None = None) -> None:
        """Snapshot ``tree`` to host memory now (device to host copies),
        then write it: here, or with ``wait=False`` on a thread, which
        ``wait_for_save`` (or the next ``save``) joins. ``extra`` is a
        JSON-serializable blob stored in the manifest."""
        self.wait_for_save()
        leaves, _ = tree_flatten(tree)
        host = [_snapshot(leaf) for leaf in leaves]
        manifest = {"step": step, "treedef": treedef_str(tree),
                    "extra": extra,
                    "leaves": [{"file": f"leaf_{i:05d}.npy",
                                "shape": list(a.shape), "dtype": dt}
                               for i, (a, dt) in enumerate(host)]}

        def write():
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = _step_dir(self.dir, step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, (a, dt) in enumerate(host):
                _save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), a, dt)
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                   # atomic publish
            self._gc()

        if wait:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait_for_save(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            raise FileNotFoundError(f"no checkpoint directory {self.dir}")
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_manifest(self, *, step: int | None = None) -> dict:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(os.path.join(_step_dir(self.dir, step),
                               "manifest.json")) as fh:
            return json.load(fh)

    def restore(self, target_tree, *, step: int | None = None, device=None):
        """(``target_tree``'s structure holding the step's leaves, step).
        The target's leaves are not read. Each leaf comes back as a tensor
        of its manifest dtype, on ``device`` (``None`` leaves it on the
        host, as the reference's restore without ``shardings`` does)."""
        manifest = self.load_manifest(step=step)
        path = _step_dir(self.dir, manifest["step"])
        targets, treedef = tree_flatten(target_tree)
        if len(targets) != len(manifest["leaves"]):
            raise ValueError(f"{path} holds {len(manifest['leaves'])} "
                             f"leaves, the target tree {len(targets)}")
        leaves = [_load_leaf(os.path.join(path, leaf["file"]), leaf["dtype"])
                  for leaf in manifest["leaves"]]
        if device is not None:
            dev = resolve_device(device)
            leaves = [t.to(dev) for t in leaves]
        return tree_unflatten(treedef, leaves), manifest["step"]


# ---------------------------------------------------------------------------
# GeekModel save/restore
# ---------------------------------------------------------------------------

def save_model(directory: str, model, *, step: int = 0,
               wait: bool = True) -> None:
    """Persist a fitted GeekModel, readable by ``repro``'s restore_model
    (except a sparse model's transform: ``core.transform``)."""
    dtypes = dict(_LEAF_DTYPES, centers=_CENTER_DTYPES[model.metric][0])
    arrays = {f: _host(getattr(model, f)).astype(dtypes[f])
              for f in model_mod.ARRAY_FIELDS}
    tmeta = None
    if model.transform is not None:
        tmeta = transform_mod.transform_meta(model.transform)
        for name, arr in transform_mod.transform_arrays(model.transform).items():
            arrays["transform_" + name] = _host(arr)
    CheckpointManager(directory).save(
        step, arrays, wait=wait,
        extra={"kind": "geek_model", "meta": model.static_meta(),
               "transform": tmeta, "fields": sorted(arrays)})


def model_from_numpy(arrays: dict[str, np.ndarray], meta: dict,
                     device, *, index_hashers: tuple | None = None
                     ) -> model_mod.GeekModel:
    """Build a GeekModel on ``device`` from host arrays and metadata.

    ``arrays`` holds the canonical fields (``model.ARRAY_FIELDS``) and
    any ``transform_``-prefixed leaves; ``meta`` is the manifest's
    ``extra`` blob (``{"meta": ..., "transform": ...}``). The center
    index is rebuilt, as the reference rebuilds it on restore: from the
    port's own hash functions, or from ``index_hashers``, the
    reference's ``CenterIndex.hashers`` as numpy (l2: ``(proj,)``;
    hamming: the raw ``(item_key, sig_keys)``), so an index can be built
    on the reference's projection.
    """
    dev = resolve_device(device)
    transform = None
    if meta.get("transform") is not None:
        prefix = "transform_"
        tarrays = {k[len(prefix):]: v for k, v in arrays.items()
                   if k.startswith(prefix)}
        transform = transform_mod.transform_from(meta["transform"], tarrays,
                                                 device=dev)
    m = meta["meta"]

    def t(name):
        return torch.as_tensor(np.asarray(arrays[name]), device=dev)

    model = model_mod.build_model(
        t("centers").to(_CENTER_DTYPES[m["metric"]][1]),
        t("center_valid").to(torch.bool),
        t("k_star").to(torch.int32), t("radius").to(torch.float32),
        metric=m["metric"], impl=m["impl"], code_bits=m["code_bits"],
        assign_block=m["assign_block"], use_pallas=m["use_pallas"],
        transform=transform, bucketer_id=m.get("bucketer_id", ""),
        seeder_id=m.get("seeder_id", ""),
        index_tables=m.get("index_tables", 8),
        index_bucket=m.get("index_bucket", 32))
    if index_hashers is None or model.center_index is None:
        return model
    if m["metric"] == "l2":
        hashers = (torch.as_tensor(np.array(index_hashers[0])),)
    else:
        item_key, sig_keys = index_hashers
        hashers = (derive_hash_keys_from_key(np.asarray(item_key), (1,)),
                   torch.from_numpy(np.asarray(sig_keys).astype(np.int64)))
    return dataclasses.replace(model, center_index=model_mod.build_center_index(
        model.centers, model.center_valid, metric=model.metric,
        tables=model.index_tables, bucket=model.index_bucket,
        hashers=hashers))


def restore_model(directory: str, *, step: int | None = None,
                  device=None, mesh=None) -> model_mod.GeekModel:
    """Rebuild a GeekModel from ``save_model`` files, either package's.

    ``device`` as in ``GEEK``: ``None`` is ``cuda``, ``"cpu"`` the plain
    path. With ``mesh`` (a ``utils.compat.Mesh``) every rank restores the
    same model on ``device``, ready for ``make_predict_sharded``; the
    mesh's backend must be the device's (NCCL for ``cuda``, gloo for the
    CPU), else this raises.
    Pre-transform checkpoints (no "fields" in the manifest) read the
    canonical fields in sorted order.
    """
    device = resolve_device(device)
    if mesh is not None:
        compat.check_device(mesh, device)
    manifest = CheckpointManager(directory, create=False).load_manifest(
        step=step)
    path = _step_dir(directory, manifest["step"])
    extra = manifest.get("extra") or {}
    if extra.get("kind") != "geek_model":
        raise ValueError(f"{directory} does not hold a GeekModel checkpoint")
    fields = extra.get("fields") or sorted(model_mod.ARRAY_FIELDS)
    if len(fields) != len(manifest["leaves"]):
        raise ValueError(f"{path}: {len(fields)} fields but "
                         f"{len(manifest['leaves'])} leaves")
    arrays = {f: np.load(os.path.join(path, leaf["file"]))
              for f, leaf in zip(fields, manifest["leaves"])}
    return model_from_numpy(arrays, extra, device)
