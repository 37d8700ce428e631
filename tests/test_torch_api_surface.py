"""Public-API lock of the PyTorch port, mirroring ``tests/test_api_surface.py``.

The port's supported surfaces are ``repro_torch``, ``repro_torch.core`` and
``repro_torch.serve`` ``__all__``. These snapshots fail when a surface grows
or shrinks by accident: an intended change edits both the package's
``__all__`` and the snapshot here. ``repro_torch.core`` exports every name
of ``repro.core.__all__`` and nothing the reference lacks (the names still
to port would be listed, each with its ROADMAP.md item: none is left);
``repro_torch.serve`` exports every name of ``repro.serve.__all__`` plus
the port's stacked-layer KV names.
"""
import pytest
import torch

import repro.core
import repro.serve
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
    "KMeansPPSeeder",
    "KernelAssigner",
    "LSHBucketer",
    "Mesh",
    "OnlineKVCluster",
    "SILKSeeder",
    "ScalableKMeansPPSeeder",
    "SparseData",
    "clustered_decode",
    "count_active_params",
    "count_params",
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
    "KMeansPPSeeder",
    "KernelAssigner",
    "LSHBucketer",
    "NumericDiscretizer",
    "SILKSeeder",
    "ScalableKMeansPPSeeder",
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

#: ``repro.core`` names not ported yet, by ROADMAP.md Queue 1 item (none)
CORE_NOT_PORTED: dict[str, int] = {}

#: the locked serving surface — keep sorted
TORCH_SERVE_ALL = [
    "Assignment",
    "ClusterFrontend",
    "ClusterServer",
    "KVState",
    "LayerKVCluster",
    "ModelRecord",
    "ModelRegistry",
    "OnlineKVCluster",
    "RefitAutopilot",
    "ServerClosedError",
    "WorkerPool",
    "clustered_attention",
    "clustered_decode",
    "default_kv_config",
    "ema_update",
    "make_layer_step",
    "pad_ladder",
    "stack_heads",
]

#: the port's serving names that ``repro.serve.__all__`` lacks
SERVE_PORT_ONLY = {"LayerKVCluster", "default_kv_config", "make_layer_step",
                   "stack_heads"}

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


def test_torch_serve_holds_every_name_of_repro_serve():
    """Every name of ``repro.serve.__all__`` is exported, each the port's
    own module's object; beyond them only the stacked-layer KV names."""
    ours, theirs = set(repro_torch.serve.__all__), set(repro.serve.__all__)
    assert theirs <= ours
    assert ours - theirs == SERVE_PORT_ONLY
    from repro_torch.serve import autopilot, dispatch, engine, frontend
    from repro_torch.serve import registry
    assert repro_torch.serve.ClusterServer is engine.ClusterServer
    assert repro_torch.serve.WorkerPool is dispatch.WorkerPool
    assert repro_torch.serve.ClusterFrontend is frontend.ClusterFrontend
    assert repro_torch.serve.RefitAutopilot is autopilot.RefitAutopilot
    assert repro_torch.serve.ModelRegistry is registry.ModelRegistry


def test_torch_top_level_seeders_are_the_facades():
    from repro_torch.core import api
    assert repro_torch.KMeansPPSeeder is api.KMeansPPSeeder
    assert repro_torch.ScalableKMeansPPSeeder is api.ScalableKMeansPPSeeder
    assert repro_torch.core.KMeansPPSeeder is api.KMeansPPSeeder


# ---------------------------------------------------------------------------
# the training slice (ROADMAP.md Queue 1 item 15, parts 2 and 3a)
# ---------------------------------------------------------------------------

#: reference names of the LM substrate that the port lacks (none: the
#: PartitionSpec trees came with the sharding slice)
PART3_NOT_PORTED = {}
#: fields of the reference's ``Optimizer`` that the port lacks (none)
OPTIMIZER_NOT_PORTED = {}
#: ``launch.steps`` names; ``batch_specs`` and ``token_specs`` give the
#: shapes and dtypes with their PartitionSpecs
STEPS_NAMES = ["SHAPES", "ShapeCase", "abstract_caches", "abstract_params",
               "batch_specs", "make_decode_step", "make_prefill_step",
               "make_train_step", "shape_applicable", "token_specs"]
#: launcher flags the port adds to the reference's
LAUNCH_EXTRA_FLAGS = {"train": {"--device", "--grad-accum"},
                      "serve": {"--device"}}


def _public(module) -> set[str]:
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), type(module))}


def test_torch_models_holds_the_training_names():
    """Every public name of ``repro.models`` is in ``repro_torch.models``
    (``train_loss``, ``param_specs`` and ``cache_specs`` with the rest)."""
    import repro.models
    import repro_torch.models
    theirs = _public(repro.models) - {"annotations"}
    ours = _public(repro_torch.models)
    assert "train_loss" in ours
    assert theirs - ours == set(PART3_NOT_PORTED)
    assert ours - theirs == {"params_from_numpy", "params_to_numpy"}
    from repro_torch.models import model
    assert repro_torch.models.train_loss is model.train_loss


def test_torch_optim_is_repro_optim():
    import repro.optim
    import repro_torch.optim
    assert sorted(repro_torch.optim.__all__) == sorted(
        _public(repro.optim) - {"annotations"})
    assert set(repro.optim.Optimizer._fields) - set(
        repro_torch.optim.Optimizer._fields) == set(OPTIMIZER_NOT_PORTED)
    assert set(repro_torch.optim.Optimizer._fields) == set(
        repro.optim.Optimizer._fields)


#: the names of ``repro.models.sharding`` and ``repro.launch.mesh`` the
#: port carries (the rest of their namespaces are their imports)
SHARDING_NAMES = ["P", "activation_sharding", "constrain", "dp_size",
                  "tp_size"]
MESH_NAMES = ["_logical_map", "make_cluster_mesh", "make_production_mesh",
              "make_test_mesh", "replicated", "resolve_spec",
              "shardings_for", "shardings_for_dropped"]


@pytest.mark.parametrize("module,names", [
    ("models.sharding", SHARDING_NAMES), ("launch.mesh", MESH_NAMES)])
def test_torch_sharding_and_mesh_hold_the_reference_names(module, names):
    """``repro_torch.models.sharding`` and ``repro_torch.launch.mesh``
    hold the reference modules' names; every function of the reference's
    is among them."""
    import importlib
    import inspect
    theirs = importlib.import_module(f"repro.{module}")
    ours = importlib.import_module(f"repro_torch.{module}")
    own = {n for n, v in vars(theirs).items() if inspect.isfunction(v)
           and v.__module__ == theirs.__name__}
    assert own <= set(names)
    for name in names:
        assert hasattr(theirs, name) and hasattr(ours, name), name


def test_torch_token_pipelines_mirror_the_reference():
    import dataclasses

    from repro.data import tokens as jt
    from repro_torch.data import tokens as tt
    for name in ("TokenPipeline", "EmbeddingPipeline"):
        assert [f.name for f in dataclasses.fields(getattr(tt, name))] == \
            [f.name for f in dataclasses.fields(getattr(jt, name))]
        assert {"global_batch"} <= set(dir(getattr(tt, name)))
    assert callable(tt.TokenPipeline.host_batch)


def test_torch_checkpoint_manager_mirrors_the_reference():
    """``CheckpointManager`` with the reference's methods; its restore
    takes ``device=`` where the reference takes ``shardings=``."""
    import inspect

    import repro.checkpoint
    import repro_torch.checkpoint
    ours = repro_torch.checkpoint.CheckpointManager
    theirs = repro.checkpoint.CheckpointManager
    methods = {n for n in dir(theirs) if not n.startswith("_")}
    assert methods == {n for n in dir(ours) if not n.startswith("_")}
    for name in methods:
        a = list(inspect.signature(getattr(theirs, name)).parameters)
        b = list(inspect.signature(getattr(ours, name)).parameters)
        assert [p.replace("shardings", "device") for p in a] == b, name


def test_torch_launch_steps_and_launchers_mirror_the_reference():
    """``launch.steps`` holds the reference's names; ``launch.train`` and
    ``launch.serve`` take every flag of the reference's and
    ``LAUNCH_EXTRA_FLAGS``."""
    import pathlib
    import re

    from repro.launch import steps as jsteps
    from repro_torch.launch import serve, steps, train
    assert sorted(n for n in STEPS_NAMES if hasattr(steps, n)) == STEPS_NAMES
    assert set(STEPS_NAMES) <= _public(jsteps)
    src = pathlib.Path(jsteps.__file__).parent
    for name, module in (("train", train), ("serve", serve)):
        flags = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                               (src / f"{name}.py").read_text()))
        ours = {a for action in module.build_parser()._actions
                for a in action.option_strings if a.startswith("--")}
        assert ours - {"--help"} == flags | LAUNCH_EXTRA_FLAGS[name], name
