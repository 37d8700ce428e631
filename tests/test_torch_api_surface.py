"""Public-API lock of the PyTorch port, mirroring ``tests/test_api_surface.py``.

The port's supported surfaces are ``repro_torch``, ``repro_torch.core`` and
``repro_torch.serve`` ``__all__``. These snapshots fail when a surface grows
or shrinks by accident: an intended change edits both the package's
``__all__`` and the snapshot here. ``repro_torch.core`` exports the names
of ``repro.core.__all__`` that are ported and nothing the reference lacks;
the names still to port are listed, each with its ROADMAP.md item.
"""
import pytest
import torch

import repro.core
import repro_torch
import repro_torch.core
import repro_torch.serve

# One intra-op thread: the suite runs several workers on the machine's
# cores, and a full torch thread pool in each of them oversubscribes them.
torch.set_num_threads(1)

#: the locked top-level surface — keep sorted
TORCH_ALL = [
    "DenseData",
    "GEEK",
    "GeekConfig",
    "GeekModel",
    "GeekResult",
    "HeteroData",
    "KernelAssigner",
    "LSHBucketer",
    "Mesh",
    "OnlineKVCluster",
    "SILKSeeder",
    "SparseData",
    "clustered_decode",
    "get_arch",
    "init_params",
    "make_fit_dense",
    "make_mesh",
    "make_predict_sharded",
    "predict",
    "restore_model",
    "save_model",
]

#: the locked core surface — keep sorted
TORCH_CORE_ALL = [
    "CenterIndex",
    "DenseData",
    "GEEK",
    "GeekConfig",
    "GeekModel",
    "GeekResult",
    "HeteroData",
    "HeteroTransform",
    "IdentityTransform",
    "KernelAssigner",
    "LSHBucketer",
    "NumericDiscretizer",
    "SILKSeeder",
    "SeedPairs",
    "Seeds",
    "SparseData",
    "SparseTransform",
    "as_dataset",
    "build_center_index",
    "build_model",
    "discover",
    "patch_probed_fallback",
    "predict",
    "predict_probed",
    "silk_seeding",
    "update_centers",
]

#: ``repro.core`` names not ported yet, by ROADMAP.md Queue 1 item
CORE_NOT_PORTED = {"KMeansPPSeeder": 10, "ScalableKMeansPPSeeder": 10}

#: the locked serving surface — keep sorted
TORCH_SERVE_ALL = [
    "KVState",
    "LayerKVCluster",
    "OnlineKVCluster",
    "clustered_attention",
    "clustered_decode",
    "default_kv_config",
    "ema_update",
    "make_layer_step",
    "stack_heads",
]

SURFACES = {"repro_torch": (repro_torch, TORCH_ALL),
            "repro_torch.core": (repro_torch.core, TORCH_CORE_ALL),
            "repro_torch.serve": (repro_torch.serve, TORCH_SERVE_ALL)}


@pytest.mark.parametrize("name", list(SURFACES))
def test_torch_surface_locked(name):
    module, locked = SURFACES[name]
    assert sorted(module.__all__) == sorted(locked)
    assert module.__all__ == sorted(module.__all__), "__all__ must stay sorted"


@pytest.mark.parametrize("name", list(SURFACES))
def test_torch_surface_resolves(name):
    module, _ = SURFACES[name]
    for attr in module.__all__:
        assert getattr(module, attr) is not None, f"{name}.{attr}"


def test_torch_core_is_the_ported_part_of_repro_core():
    """Every exported name is one of ``repro.core``'s, and every one of
    those is exported or listed as not ported yet."""
    ours, theirs = set(repro_torch.core.__all__), set(repro.core.__all__)
    assert ours <= theirs
    assert theirs - ours == set(CORE_NOT_PORTED)
    assert not any(hasattr(repro_torch.core, n) for n in CORE_NOT_PORTED)


def test_torch_core_names_are_the_implementations():
    """The re-exports are the modules' own objects, as in ``repro.core``."""
    from repro_torch.core import (GEEK, DenseData, build_model,
                                  update_centers)
    from repro_torch.core import api, model
    assert GEEK is api.GEEK and DenseData is api.DenseData
    assert build_model is model.build_model
    assert update_centers is model.update_centers
    assert repro_torch.GEEK is GEEK and repro_torch.predict is model.predict
