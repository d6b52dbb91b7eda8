"""The elastic reshard of ``ckpt.restore(mesh=, pspecs=)`` across packages
(the counterpart of ``tests/test_checkpoint.py::test_elastic_reshard_restore``):
the reference saves and the port restores onto ``mesh8`` and ``mesh_dm``,
every shard equal bit for bit to the reference's own sharded restore's
``addressable_shards[i]`` (the model template filled in place, its entry
the shard tree; a dict template's too); the port saves and the reference
restores with ``mesh8``, every leaf equal. A restore whose spec does not
divide raises before the model is touched; without a mesh, ``restore`` is
as before.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.dist import sharding as ref_shd
from repro.models import api as ref_api
from repro.train import optim as ref_optim
from repro_torch.checkpoint import ckpt
from repro_torch.dist import sharding as shd
from repro_torch.models import api
from repro_torch.train import optim
from test_torch_lm_common import to_numpy
from test_torch_train_common import assert_trees_equal, port_model, ref_init, tiny

PORT_MESHES = {"mesh8": shd.SimMesh(8), "mesh_dm": shd.SimMesh((2, 4), ("data", "model"))}


def flat(tree):
    return dict(shd.sorted_leaves(tree))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(PORT_MESHES))
def test_reference_save_port_sharded_restore(tmp_path, request, mesh_name, fsdp):
    ref_cfg, cfg = tiny("qwen3-1.7b")
    params = ref_init(ref_cfg)
    state = ref_optim.get(ref_cfg.optimizer).init(params)
    state = jax.tree.map(lambda x: x + 0.5 if x.ndim else x, state)
    path = str(tmp_path / "ck")
    ref_ckpt.save(path, 3, {"params": params, "opt_state": state})

    rmesh, pmesh = request.getfixturevalue(mesh_name), PORT_MESHES[mesh_name]
    rrules = ref_shd.rules_for_mesh(rmesh, fsdp=fsdp)
    prules = shd.rules_for_mesh(pmesh, fsdp=fsdp)
    rdefs = {"params": ref_api.param_defs(ref_cfg),
             "opt_state": ref_optim.get(ref_cfg.optimizer).state_defs(
                 ref_api.param_defs(ref_cfg))}
    pdefs = {"params": api.param_defs(cfg),
             "opt_state": optim.get(cfg.optimizer).state_defs(api.param_defs(cfg))}
    _, want = ref_ckpt.restore(path, {"params": params, "opt_state": state}, mesh=rmesh,
                               pspecs={k: ref_shd.tree_pspecs(v, rrules, rmesh)
                                       for k, v in rdefs.items()})
    model = api.build_model(cfg, "cpu")
    step, got = ckpt.restore(path, {"params": model, "opt_state": pdefs["opt_state"]},
                             mesh=pmesh, pspecs={k: shd.tree_pspecs(v, prules, pmesh)
                                                 for k, v in pdefs.items()}, device="cpu")
    assert step == 3
    # the model is filled in place from the full arrays; its entry is the shards
    assert_trees_equal(api.to_reference(model), to_numpy(params))
    n_split = 0
    for name in ("params", "opt_state"):
        w, g = flat(want[name]), flat(got[name])
        assert list(g) == list(w)
        for p, leaf in w.items():
            shards = g[p]
            assert shards.shape[0] == pmesh.ranks == len(leaf.addressable_shards)
            for i, ref_shard in enumerate(leaf.addressable_shards):
                ref_arr = np.asarray(ref_shard.data)
                assert np.array_equal(api.to_numpy(shards[i]), ref_arr.view(
                    api.to_numpy(shards[i]).dtype)), (name, p, i)
            n_split += shards.shape[1:] != tuple(leaf.shape)
    # mesh8 without fsdp replicates every leaf (the reference test's case)
    assert n_split if (fsdp or mesh_name == "mesh_dm") else n_split == 0


def test_port_save_reference_sharded_restore(tmp_path, mesh8):
    ref_cfg, cfg = tiny("qwen3-1.7b")
    params = ref_init(ref_cfg, seed=1)
    model = port_model(cfg, params)
    path = str(tmp_path / "ck")
    ckpt.save(path, 7, {"params": model})
    rules = ref_shd.rules_for_mesh(mesh8, fsdp=True)
    pspecs = ref_shd.tree_pspecs(ref_api.param_defs(ref_cfg), rules, mesh8)
    step, trees = ref_ckpt.restore(path, {"params": params}, mesh=mesh8,
                                   pspecs={"params": pspecs})
    assert step == 7
    leaf = trees["params"]["embed"]["tok"]
    assert isinstance(leaf.sharding, jax.sharding.NamedSharding)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(trees["params"])):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sharded_restore_refuses_before_filling(tmp_path):
    """A spec that does not divide raises while placing, before the model
    is written: the template keeps every value it had."""
    _, cfg = tiny("qwen3-1.7b")
    path = str(tmp_path / "ck")
    ckpt.save(path, 1, {"params": api.init_params(cfg, 0, device="cpu")})
    template = api.init_params(cfg, 5, device="cpu")
    before = copy.deepcopy(api.to_reference(template))
    mesh = shd.SimMesh((2, 4), ("data", "model"))
    specs = shd.tree_map(lambda pd: (), api.param_defs(cfg))
    specs["embed"]["tok"] = ("model", "data")  # vocab 256 / 4, d 64 / 2: divides
    specs["final_norm"]["scale"] = ("model",)  # 64 / 4 divides too
    specs2 = copy.deepcopy(specs)
    # the stacked layer axis (2 layers) over the 4-way model axis: placed
    # after embed and final_norm, it raises
    specs2["groups"] = shd.tree_map(lambda s: ("model",), specs2["groups"])
    with pytest.raises(ValueError):
        ckpt.restore(path, {"params": template}, mesh=mesh, pspecs={"params": specs2},
                     device="cpu")
    assert_trees_equal(api.to_reference(template), before)
    # the same restore with dividing specs fills it and returns the shards
    _, trees = ckpt.restore(path, {"params": template}, mesh=mesh, pspecs={"params": specs},
                            device="cpu")
    tok = trees["params"]["embed"]["tok"]
    assert tok.shape == (8, cfg.vocab // 4, cfg.d_model // 2)
    assert torch.equal(shd.gather(tok, specs["embed"]["tok"], mesh),
                       template.embed.tok.detach())
    with pytest.raises(AssertionError):
        assert_trees_equal(api.to_reference(template), before)


def test_restore_without_mesh_unchanged(tmp_path):
    """mesh= without pspecs (or a name pspecs lacks) restores as before."""
    _, cfg = tiny("qwen3-1.7b")
    model = api.init_params(cfg, 0, device="cpu")
    path = str(tmp_path / "ck")
    ckpt.save(path, 2, {"params": model})
    mesh = shd.SimMesh(8)
    for kw in ({}, {"mesh": mesh}, {"mesh": mesh, "pspecs": {"other": {}}}):
        template = api.build_model(cfg, "cpu")
        _, trees = ckpt.restore(path, {"params": template}, device="cpu", **kw)
        assert trees["params"] is template
        assert_trees_equal(api.to_reference(template), api.to_reference(model))
