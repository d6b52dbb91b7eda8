"""The encoder-decoder family (whisper) sharded over the model axis: the
port on ``SimMesh((2, 4), ("data", "model"))`` against the JAX package on
``mesh_dm``; the checks of ``test_torch_tp_common``. The reduced config's
2 kv heads fall back to replicated on the 4-way axis; ``n_kv_heads=4``
splits them, in the self and the cross attention (the cross cache
all-gathered in the prefill). The train steps are held one at a time from
the reference's state before each (``check_each_step``): whisper's
gradient has 0.3-0.7 % of its elements under AdamW's ill-conditioned
bound at each step, over 1 % across three (1.1 % at the split-kv
config's third step alone), past what ``assert_adam_close`` admits. The
split-kv config's loss and gradient are held to ``jax.value_and_grad`` of
the reference's loss on ``mesh_dm`` directly (no AdamW step between them),
and to the unsharded port's, its record to the byte model."""

import jax
import numpy as np
import pytest

from repro.models import api as ref_api
from repro_torch.models import api, lm
from repro_torch.train import step as step_mod
from test_torch_train_common import as_torch, assert_trees_close
from test_torch_tp_common import (BATCH, GRAD_ATOL, GRAD_RTOL, MESH, ROWS, RULES, SEQ, SIZE,
                                  case_id, check_checkpoint, check_decode, check_each_step,
                                  check_generate, check_loss, check_prefill, check_round_trip,
                                  configs_of, inputs, one_torch_thread,  # noqa: F401
                                  place_params, place_rows, port_sharded, ref_params,
                                  ref_rules, serve_reference, step_reference)

CASES = [("whisper-medium", None), ("whisper-medium", {"n_kv_heads": 4})]
IDS = [case_id(a, c) for a, c in CASES]
TRAIN = CASES[:1]


@pytest.fixture(scope="module")
def serving(mesh_dm):
    return serve_reference(mesh_dm)


@pytest.fixture(scope="module")
def gspmd(mesh_dm):
    return step_reference(mesh_dm, "gspmd")


@pytest.fixture(scope="module")
def butterfly(mesh_dm):
    return step_reference(mesh_dm, "butterfly")


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_prefill_and_cache_match_reference(serving, arch, changes):
    check_prefill(serving, arch, changes)


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_decode_steps_match_reference(serving, arch, changes):
    check_decode(serving, arch, changes)


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_generate_greedy_tokens_equal_reference(serving, arch, changes):
    check_generate(serving, arch, changes)


@pytest.mark.parametrize("arch,changes", TRAIN, ids=IDS[:1])
def test_train_loss_matches_reference(gspmd, arch, changes):
    check_loss(gspmd, arch, changes)


@pytest.mark.parametrize("arch,changes", TRAIN, ids=IDS[:1])
def test_gspmd_step_matches_reference(gspmd, arch, changes):
    check_each_step(gspmd, arch, "gspmd", changes)


@pytest.mark.parametrize("arch,changes", TRAIN, ids=IDS[:1])
def test_butterfly_step_matches_reference(butterfly, arch, changes):
    check_each_step(butterfly, arch, "butterfly", changes)


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_to_reference_round_trip(arch, changes):
    check_round_trip(arch, changes)


def test_sharded_checkpoint_restores(tmp_path):
    check_checkpoint(tmp_path, *CASES[0])


def test_split_kv_gradient_equals_unsharded():
    """The split-kv config's sharded gradient (the cross attention's keys
    and values projected from the encoder's output through ``tp.copy``)
    against the unsharded port's, and its record against the byte model."""
    _, cfg = configs_of(*CASES[1])
    plain = api.init_params(cfg, 0, device="cpu")
    sharded = api.shard(plain, RULES, MESH)
    batch = as_torch(inputs(cfg))
    loss0, g0 = step_mod._grads_of(api.train_loss_fn(cfg), plain, batch, 1)
    sharded.tp.reset()
    loss1, g1 = step_mod._grads_of(api.train_loss_fn(cfg, RULES, MESH), sharded, batch, 1)
    assert abs(float(loss1) - float(loss0)) <= 1e-5
    assert_trees_close(api.global_leaves(sharded, g1), g0, GRAD_RTOL, GRAD_ATOL, "gradient")
    want = lm.tp_calls(cfg, "train", BATCH // ROWS, SEQ, SIZE)
    assert sorted(sharded.tp.calls) == sorted(want)


def test_split_kv_gradient_matches_reference(mesh_dm):
    """The split-kv config's sharded loss and gradient (the split branch of
    ``cross_kv_tp`` and the cross cache's gather in the backward) against
    ``jax.value_and_grad`` of the reference's loss on ``mesh_dm`` with its
    rules, the same weights and batch; the record against the byte model."""
    ref_cfg, cfg = configs_of(*CASES[1])
    params = ref_params(ref_cfg)
    batch = inputs(cfg)
    loss_fn = ref_api.train_loss_fn(ref_cfg, ref_rules(mesh_dm), mesh_dm)
    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
        place_params(ref_cfg, params, mesh_dm), place_rows(batch, mesh_dm))
    model = port_sharded(cfg, params)
    model.tp.reset()
    loss, got = step_mod._grads_of(api.train_loss_fn(cfg, RULES, MESH), model, as_torch(batch), 1)
    assert abs(float(loss) - float(want_loss)) <= 1e-5, (float(loss), float(want_loss))
    assert_trees_close(api.global_leaves(model, got), jax.tree.map(np.asarray, want), GRAD_RTOL,
                       GRAD_ATOL, "split-kv gradient")
    want_calls = lm.tp_calls(cfg, "train", BATCH // ROWS, SEQ, SIZE)
    assert sorted(model.tp.calls) == sorted(want_calls)
