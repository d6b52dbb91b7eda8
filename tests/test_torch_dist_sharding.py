"""The mesh half of the port's ``dist.sharding`` and ``launch.mesh`` against
the JAX package's: ``rules_for_mesh``, ``spec_for`` / ``tree_pspecs`` on
the parameter, input and cache descriptors of all ten full configs, on
``mesh8`` (data 8), ``mesh_dm`` (data 2 x model 4), ``mesh24`` (pod 2 x
data 4) and both production meshes, fsdp on and off: equal entry for
entry. The reference's ``spec_for`` reads only ``mesh.shape`` (and
``rules_for_mesh`` only ``mesh.axis_names``), so the production meshes'
specs come from a stand-in with those two attributes, without 256
devices. ``tree_structs``' shard shapes equal ``NamedSharding.shard_shape``
on ``mesh_dm``; ``place`` gives shard ``i`` equal bit for bit to the
reference's ``addressable_shards[i]`` on ``mesh8`` and ``mesh_dm``, and
``gather`` inverts it.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro import configs as ref_configs
from repro.configs.base import SHAPES as REF_SHAPES
from repro.dist import sharding as ref_shd
from repro.models import api as ref_api
from repro.train import optim as ref_optim
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api
from repro_torch.train import optim

MESHES = {
    "mesh8": ((8,), ("data",)),
    "mesh_dm": ((2, 4), ("data", "model")),
    "mesh24": ((2, 4), ("pod", "data")),
    "production": ((16, 16), ("data", "model")),
    "production_multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}


def ref_mesh(request, name):
    """The conftest's mesh of that name, or a stand-in with the reference's
    ``shape`` and ``axis_names`` for a production mesh."""
    if name in ("mesh8", "mesh_dm", "mesh24"):
        return request.getfixturevalue(name)
    sizes, names = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)


def port_mesh(name):
    if name == "production":
        return mesh_mod.make_production_mesh()
    if name == "production_multi_pod":
        return mesh_mod.make_production_mesh(multi_pod=True)
    return shd.SimMesh(*MESHES[name])


def desc_trees(api_mod, cfg, shapes):
    """Every descriptor tree of a config: params, the inputs of every
    shape, the decode caches."""
    out = {"params": api_mod.param_defs(cfg)}
    for name, sh in shapes.items():
        out[f"inputs/{name}"] = api_mod.input_defs(cfg, sh)
        if sh.kind == "decode":
            out[f"cache/{name}"] = api_mod.cache_defs(cfg, sh)
    return out


def flat(tree):
    return dict(shd.sorted_leaves(tree))


def test_simmesh_axes_and_order():
    m = shd.SimMesh((2, 3, 4), ("pod", "data", "model"))
    assert m.ranks == 24 and m.shape == {"pod": 2, "data": 3, "model": 4}
    assert list(m.shape) == ["pod", "data", "model"]
    # row-major: the last axis varies fastest, as jax.make_mesh's devices
    assert m.coords([0, 1, 4, 23]).tolist() == [[0, 0, 0], [0, 0, 1], [0, 1, 0], [1, 2, 3]]
    assert m.axis_stride("pod") == 12 and m.axis_stride("model") == 1
    assert m.group_index([5, 17], ("pod", "model")).tolist() == [1, 5]
    assert shd.SimMesh(8) == shd.SimMesh((8,), ("data",))
    assert shd.SimMesh(8).shape == {"data": 8} and shd.SimMesh(8).ranks == 8
    with pytest.raises(ValueError):
        shd.SimMesh((2, 4), ("data",))
    with pytest.raises(ValueError):
        shd.SimMesh((2, 4), ("data", "data"))


def test_launch_meshes(mesh8):
    prod, multi = mesh_mod.make_production_mesh(), mesh_mod.make_production_mesh(multi_pod=True)
    # the reference's make_production_mesh shapes and axes
    assert (prod.sizes, prod.axis_names) == ((16, 16), ("data", "model"))
    assert (multi.sizes, multi.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    host = mesh_mod.make_host_mesh(8)
    assert dict(host.shape) == dict(mesh8.shape)
    assert host.axis_names == tuple(mesh8.axis_names)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_for_mesh_match_reference(request, mesh_name, fsdp):
    ref = ref_shd.rules_for_mesh(ref_mesh(request, mesh_name), fsdp=fsdp)
    port = shd.rules_for_mesh(port_mesh(mesh_name), fsdp=fsdp)
    assert (port.batch, port.model, port.fsdp) == (ref.batch, ref.model, ref.fsdp)
    for logical in ("batch", "heads", "kv_heads", "ff", "vocab", "experts", "d_inner",
                    "embed", "layers", None):
        assert port.axes_for(logical) == ref.axes_for(logical)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_specs_match_reference(request, arch, mesh_name, fsdp):
    """tree_pspecs of every descriptor tree of the full config, entry for
    entry (spec_for's divisibility fallback and dropped trailing Nones)."""
    rmesh, pmesh = ref_mesh(request, mesh_name), port_mesh(mesh_name)
    rrules = ref_shd.rules_for_mesh(rmesh, fsdp=fsdp)
    prules = shd.rules_for_mesh(pmesh, fsdp=fsdp)
    ref_trees = desc_trees(ref_api, ref_configs.get_config(arch), REF_SHAPES)
    port_trees = desc_trees(api, configs.get_config(arch), SHAPES)
    ref_trees["opt_state"] = ref_optim.get(ref_configs.get_config(arch).optimizer).state_defs(
        ref_trees["params"])
    port_trees["opt_state"] = optim.get(configs.get_config(arch).optimizer).state_defs(
        port_trees["params"])
    assert list(ref_trees) == list(port_trees)
    n_sharded = 0
    for key in ref_trees:
        want = flat(ref_shd.tree_pspecs(ref_trees[key], rrules, rmesh))
        got = flat(shd.tree_pspecs(port_trees[key], prules, pmesh))
        assert list(got) == list(want), key
        for path, spec in want.items():
            assert got[path] == tuple(spec), (key, path, got[path], spec)
            assert isinstance(got[path], tuple)
            n_sharded += any(e is not None for e in spec)
    if mesh_name != "mesh24" or fsdp:
        assert n_sharded  # something shards on every mesh with a model axis or fsdp


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_tree_structs_match_named_sharding(mesh_dm, arch):
    """ShardStruct's shard shape == NamedSharding(mesh_dm, spec).shard_shape,
    and its dtype == the reference struct's, for params, optimizer state,
    the train inputs and the decode cache."""
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    rrules = ref_shd.rules_for_mesh(mesh_dm, rcfg.fsdp)
    pmesh = port_mesh("mesh_dm")
    prules = shd.rules_for_mesh(pmesh, cfg.fsdp)
    pairs = [
        (ref_api.param_defs(rcfg), api.param_defs(cfg), rcfg.param_dtype),
        (ref_optim.get(rcfg.optimizer).state_defs(ref_api.param_defs(rcfg)),
         optim.get(cfg.optimizer).state_defs(api.param_defs(cfg)), "float32"),
        (ref_api.input_defs(rcfg, REF_SHAPES["train_4k"]),
         api.input_defs(cfg, SHAPES["train_4k"]), rcfg.compute_dtype),
        (ref_api.cache_defs(rcfg, REF_SHAPES["decode_32k"]),
         api.cache_defs(cfg, SHAPES["decode_32k"]), rcfg.compute_dtype),
    ]
    for rdefs, pdefs, dtype in pairs:
        want = flat(ref_shd.tree_structs(rdefs, dtype, rrules, mesh_dm))
        got = flat(shd.tree_structs(pdefs, dtype, prules, pmesh))
        assert list(got) == list(want)
        for path, st in want.items():
            g = got[path]
            assert g.shape == tuple(st.shape)
            assert g.shard_shape == tuple(st.sharding.shard_shape(st.shape)), path
            assert g.spec == tuple(st.sharding.spec)
            assert str(g.dtype).replace("torch.", "") == jnp.dtype(st.dtype).name


def _placement_cases():
    """(path, array) of seeded arrays in the reduced qwen3-1.7b's parameter
    shapes, plus shapes that divide every way and an int32 leaf."""
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    rng = np.random.default_rng(0)
    defs = dict(shd.sorted_leaves(api.param_defs(cfg)))
    defs[("extra", "divisible")] = shd.PD((8, 12, 16), ("batch", None, "heads"))
    defs[("extra", "tokens")] = shd.PD((16, 4), ("batch", None), dtype="int32")
    out = {}
    for path, pd in defs.items():
        if pd.dtype == "int32":
            out[path] = (pd, rng.integers(-100, 100, pd.shape).astype(np.int32))
        else:
            out[path] = (pd, rng.normal(size=pd.shape).astype(np.float32))
    return out


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", ["mesh8", "mesh_dm"])
def test_place_matches_addressable_shards(request, mesh_name, fsdp):
    rmesh, pmesh = request.getfixturevalue(mesh_name), port_mesh(mesh_name)
    rrules = ref_shd.rules_for_mesh(rmesh, fsdp=fsdp)
    prules = shd.rules_for_mesh(pmesh, fsdp=fsdp)
    n_split = 0
    for path, (pd, arr) in _placement_cases().items():
        spec = shd.spec_for(pd, prules, pmesh)
        assert spec == tuple(ref_shd.spec_for(pd, rrules, rmesh))
        placed = jax.device_put(arr, NamedSharding(rmesh, ref_shd.spec_for(pd, rrules, rmesh)))
        shards = shd.place(torch.from_numpy(arr), spec, pmesh)
        assert shards.shape == (pmesh.ranks,) + shd.shard_shape(arr.shape, spec, pmesh)
        assert len(placed.addressable_shards) == pmesh.ranks
        for i, ref_shard in enumerate(placed.addressable_shards):
            assert np.array_equal(shards[i].numpy(), np.asarray(ref_shard.data)), (path, i)
        assert torch.equal(shd.gather(shards, spec, pmesh), torch.from_numpy(arr))
        n_split += any(e is not None for e in spec)
    assert n_split >= 2


def test_place_refuses_a_spec_that_does_not_divide():
    mesh = shd.SimMesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError):
        shd.place(torch.zeros(6, 3), ("model",), mesh)
    with pytest.raises(ValueError):
        shd.gather(torch.zeros(4, 3), (), mesh)
    with pytest.raises(ValueError):  # NamedSharding refuses it too
        shd.place(torch.zeros(8, 8), ("data", "data"), mesh)
    # a multi-axis entry splits over the axes' row-major index
    x = torch.arange(16).reshape(8, 2)
    shards = shd.place(x, (("data", "model"),), mesh)
    assert torch.equal(shards[:, :, 0], torch.arange(0, 16, 2).reshape(8, 1))
    assert dataclasses.is_dataclass(shd.tree_structs(
        {"w": shd.PD((8, 2), ("batch", None))}, "float32",
        shd.rules_for_mesh(mesh), mesh)["w"])
