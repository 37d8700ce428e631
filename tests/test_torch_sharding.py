"""The port's logical-axis sharding against the reference's: the spec
trees of every model, optimizer and batch (``param_specs``,
``cache_specs``, ``state_specs``, ``batch_specs``, ``token_specs``),
``launch.mesh.resolve_spec`` and the production meshes, the placements a
spec resolves to, and ``models.sharding.constrain`` with no mesh.

Specs are compared as trees of axis names: the port's ``P`` equals the
tuple of its entries, and the reference's ``PartitionSpec`` is turned
into that tuple. The port's parameter tree holds one dictionary per layer
and the reference's stacks each period position's layers, so the port's
trees are compared through ``convert.specs_to_reference_layout``, which
puts the stacking axis's ``None`` in front. Adafactor's row and column
specs follow each leaf's rank, which the stacking raises by one (a
layer's 1-D leaf is factored in the reference's stacked layout only); so
its state specs are held to the reference's ``state_specs`` called on the
port's own per-layer specs and shapes.
"""
import os
import subprocess
import sys
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import _torch_dist
from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.launch import mesh as JMESH
from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTRAIN
from repro_torch.models import model as TM
from repro_torch.models import sharding as SH
from repro_torch.models.convert import specs_to_reference_layout
from repro_torch.models.sharding import P
from repro_torch.optim import adafactor, adamw
from repro_torch.utils.tree import tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the ten smoke configs, and Qwen3-0.6B at full width
CONFIGS = [(a, True) for a in j_list_archs()] + [("qwen3_0_6b", False)]


def _names(tree):
    """A reference spec tree as tuples of axis names."""
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, JP))


def _cfgs(arch, smoke):
    return j_get_arch(arch, smoke=smoke), get_arch(arch, smoke=smoke)


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_param_and_cache_specs_are_the_reference_specs(arch, smoke):
    jcfg, cfg = _cfgs(arch, smoke)
    specs = TM.param_specs(cfg)
    assert specs_to_reference_layout(specs, cfg) == \
        _names(JM.param_specs(jcfg))
    assert specs_to_reference_layout(TM.cache_specs(cfg), cfg) == \
        _names(JM.cache_specs(jcfg))
    # one spec a parameter, of at most its rank
    flat = tree_map(lambda s, t: len(s) <= t.ndim, specs,
                    TS.abstract_params(cfg), is_leaf=SH.is_spec)
    assert all(jax.tree.leaves(flat))


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_optimizer_state_specs_are_the_reference_specs(arch, smoke):
    jcfg, cfg = _cfgs(arch, smoke)
    specs = TM.param_specs(cfg)
    jspecs = JM.param_specs(jcfg)
    got = adamw(1e-3).state_specs(specs, None)
    want = j_adamw(1e-3).state_specs(jspecs, JS.abstract_params(jcfg))
    assert {k: specs_to_reference_layout(v, cfg) for k, v in got.items()} \
        == _names(want)
    ap = TS.abstract_params(cfg)
    got = adafactor(1e-3).state_specs(specs, ap)
    assert specs_to_reference_layout(got["mu"], cfg) == _names(jspecs)
    # the reference's function on the port's per-layer specs and shapes
    as_jax = tree_map(lambda s: JP(*s), specs, is_leaf=SH.is_spec)
    shapes = tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                     jax.numpy.float32), ap)
    want = j_adafactor(1e-3).state_specs(as_jax, shapes)
    assert got == _names(want)


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_batch_and_token_specs_are_the_reference_specs(arch, smoke):
    jcfg, cfg = _cfgs(arch, smoke)
    for name, case in TS.SHAPES.items():
        structs, specs = TS.batch_specs(cfg, case)
        jstructs, jspecs = JS.batch_specs(jcfg, JS.SHAPES[name])
        assert specs == _names(jspecs)
        for k, t in structs.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == jstructs[k].shape
    struct, spec = TS.token_specs(cfg, 8)
    jstruct, jspec = JS.token_specs(jcfg, 8)
    assert spec == tuple(jspec) and tuple(struct.shape) == jstruct.shape


#: every entry form: names, tuples (also of names that are not logical),
#: None, and specs shorter than their tensors
SPECS = [P(), P(None), P("dp"), P("fsdp", "tp"), P("tp", "fsdp", None),
         P("dp", None, None, "sp"), P(("dp", "tp")), P(("fsdp",), None),
         P("model", "data"), P(("pod", "data"), "model"), P("sp", "dp")]
DROPS = [(), ("dp",), ("tp",), ("dp", "sp"), ("fsdp", "tp")]
MESH_AXES = [("data",), ("data", "model"), ("pod", "data", "model")]


@pytest.mark.parametrize("axes", MESH_AXES)
def test_resolve_spec_is_the_reference_resolve_spec(axes):
    """The reference's ``resolve_spec`` reads only ``mesh.axis_names``;
    the port's takes the same stand-in."""
    mesh = types.SimpleNamespace(axis_names=axes)
    assert MESH._logical_map(mesh) == JMESH._logical_map(mesh)
    for spec in SPECS:
        for drop in DROPS:
            want = JMESH.resolve_spec(JP(*spec), mesh, drop=drop)
            got = MESH.resolve_spec(spec, mesh, drop=drop)
            assert isinstance(got, P)
            assert got == tuple(want), (spec, drop)


def _mesh(shape, axes):
    """A stand-in with a DeviceMesh's shape and axis names."""
    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape,
                                 ndim=len(shape))


def test_placements_cut_dims_over_their_mesh_axes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 4), ("data", "model"))
    assert MESH.placements(P("fsdp", "tp"), mesh, (8, 12)) == \
        (Shard(0), Shard(1))
    assert MESH.placements(P("tp", "fsdp"), mesh, (8, 12)) == \
        (Shard(1), Shard(0))
    # a spec shorter than the tensor: trailing dims replicated
    assert MESH.placements(P("dp"), mesh, (4, 3, 5)) == \
        (Shard(0), Replicate())
    assert MESH.placements(P(), mesh, (3,)) == (Replicate(), Replicate())
    assert MESH.placements(P("dp"), mesh, (4,), drop=("dp",)) == \
        (Replicate(), Replicate())
    assert MESH.replicated(mesh) == (Replicate(), Replicate())
    pod = _mesh((2, 2, 2), ("pod", "data", "model"))
    # ("pod", "data") on one dim: pod-major, as NamedSharding cuts it
    assert MESH.placements(P("fsdp", "tp"), pod, (8, 2)) == \
        (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="axis order"):
        MESH.placements(P(("data", "pod")), pod, (8,))
    with pytest.raises(ValueError, match="does not divide"):
        MESH.placements(P("fsdp"), pod, (6,))
    with pytest.raises(ValueError, match="does not divide"):
        MESH.placements(P(None, "tp"), mesh, (4, 6))
    with pytest.raises(ValueError, match="more entries"):
        MESH.placements(P("dp", None), mesh, (4,))
    with pytest.raises(ValueError, match="no axis"):
        MESH.placements(P("pod"), mesh, (4,))
    tree = MESH.shardings_for({"a": P("tp"), "b": [P(), P(None, "fsdp")]},
                              mesh)
    assert tree == {"a": (Replicate(), Shard(0)),
                    "b": [(Replicate(), Replicate()),
                          (Shard(1), Replicate())]}


def test_production_meshes_are_the_reference_meshes():
    """``make_production_mesh`` on fake process groups of 256 and 512
    ranks has the reference's shapes and names (the reference's on 512
    forced CPU devices, in a subprocess)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", "from repro.launch.mesh import "
         "make_production_mesh as m\nfor p in (False, True):\n"
         "    x = m(multi_pod=p); print(repr((tuple(x.shape.values()), "
         "tuple(x.axis_names))))"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = [eval(line) for line in out.stdout.split("\n") if line]
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    got = []
    for multi_pod, world in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                                world_size=world)
        try:
            mesh = MESH.make_production_mesh(multi_pod=multi_pod)
            got.append((tuple(mesh.shape), tuple(mesh.mesh_dim_names)))
            assert list(mesh.get_coordinate()) == [s - 1 for s in mesh.shape]
        finally:
            dist.destroy_process_group()
    assert got == want


def test_constrain_with_no_mesh_is_the_identity():
    """No mesh: ``constrain`` hands back its argument itself (the decode
    step's CUDA graph and every single-card path see no new work), and
    the sizes are 1."""
    x = torch.randn(2, 3, 4)
    assert SH.constrain(x, "dp", None, "tp") is x
    assert SH.constrain(x) is x
    assert SH.value(x) is x and SH.placed("dp", None, summed=("tp",)) is None
    assert SH.tp_size() == 1 and SH.dp_size() == 1 and SH.tp_rank() == 0
    assert SH.local(lambda a: a, x, out=None, ins=(None,)) is x


def test_specs_pickle_and_compare_as_tuples():
    import pickle
    s = P("fsdp", ("pod", "data"), None)
    assert s == ("fsdp", ("pod", "data"), None) and P() == ()
    assert pickle.loads(pickle.dumps(s)) == s
    assert repr(s) == "P('fsdp', ('pod', 'data'), None)"


def test_sizes_follow_the_active_mesh_and_drop():
    mesh = _mesh((2, 4, 3), ("pod", "data", "model"))
    with SH.activation_sharding(mesh):
        assert SH.tp_size() == 3 and SH.dp_size() == 8
        with SH.activation_sharding(mesh, drop=("dp",)):
            assert SH.dp_size() == 1 and SH.tp_size() == 3
        # a plain tensor under a mesh is the rank's own value
        x = torch.ones(3)
        assert SH.constrain(x, "dp") is x
    assert SH.tp_size() == 1 and SH.dp_size() == 1


def test_trainer_mesh_must_span_the_process_group(tmp_path):
    """``--mesh`` names as many ranks as the group has, else it raises
    and names both (the reference takes the first devices instead); a
    1x1 mesh on one rank runs the same steps as the single-process
    trainer."""
    args = TTRAIN.build_parser().parse_args(
        _torch_dist.MESH_ARGS + ["--mesh", "2x2"])
    with _torch_dist.single_rank_group(str(tmp_path)):
        with pytest.raises(ValueError, match="4 ranks.*group has 1"):
            TTRAIN.train(args, log=lambda _: None)
        one = TTRAIN.train(TTRAIN.build_parser().parse_args(
            _torch_dist.MESH_ARGS + ["--mesh", "1x1"]), log=lambda _: None)
        params = SH.value(one["params"]["head"]["w"])
    single = TTRAIN.train(TTRAIN.build_parser().parse_args(
        _torch_dist.MESH_ARGS), log=lambda _: None)
    assert one["losses"] == pytest.approx(single["losses"], rel=1e-6)
    torch.testing.assert_close(params, single["params"]["head"]["w"],
                               rtol=0, atol=1e-5)
