"""GeekModel save/restore in the reference's checkpoint format, with no JAX.

The counterpart of ``repro.checkpoint.manager.save_model`` /
``restore_model``. A checkpoint directory holds ``step_<8 digits>/``
with one ``leaf_<5 digits>.npy`` per array and a ``manifest.json``
(``{"step", "treedef", "extra", "leaves"}``). Leaf *i* is the *i*-th name
of ``extra["fields"]``: the reference stores ``sorted(arrays)`` and JAX
flattens a dict in sorted-key order. The ``treedef`` string is ignored
on read. A step is written into ``tmp.<step>`` and renamed into place
only when complete, so a crash never leaves a half-written step.

``model_from_numpy`` carries state across: host arrays + manifest
metadata -> a ``GeekModel`` on a device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core import model as model_mod
from repro_torch.core import transform as transform_mod
from repro_torch.utils import compat
from repro_torch.utils.device import resolve_device
from repro_torch.utils.hashing import derive_hash_keys_from_key

#: dtypes of the canonical leaves, as the reference writes them; centers
#: are float32 centroids for l2 and int32 mode codes for hamming
_LEAF_DTYPES = {"center_valid": np.bool_, "k_star": np.int32,
                "radius": np.float32}
_CENTER_DTYPES = {"l2": (np.float32, torch.float32),
                  "hamming": (np.int32, torch.int32)}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_model(directory: str, model, *, step: int = 0) -> None:
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
    fields = sorted(arrays)
    extra = {"kind": "geek_model", "meta": model.static_meta(),
             "transform": tmeta, "fields": fields}
    manifest = {"step": step,
                "treedef": "PyTreeDef({" + ", ".join(
                    f"'{f}': *" for f in fields) + "})",
                "extra": extra,
                "leaves": [{"file": f"leaf_{i:05d}.npy",
                            "shape": list(arrays[f].shape),
                            "dtype": str(arrays[f].dtype)}
                           for i, f in enumerate(fields)]}
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = _step_dir(directory, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for i, f in enumerate(fields):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arrays[f])
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _latest_step(directory: str) -> int:
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    steps = sorted(int(name.split("_")[1]) for name in os.listdir(directory)
                   if name.startswith("step_"))
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return steps[-1]


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
    if step is None:
        step = _latest_step(directory)
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
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
