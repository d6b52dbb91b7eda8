"""The VLM family (internvl2: a dense LM behind a replicated patch
projection) sharded over the model axis: the port on ``SimMesh((2, 4),
("data", "model"))`` against the JAX package on ``mesh_dm``; the checks of
``test_torch_tp_common`` (the decode positions count the patch prefix, the
loss ignores it)."""

import pytest

from test_torch_tp_common import (case_id, check_checkpoint, check_decode, check_generate,
                                  check_loss, check_prefill, check_round_trip, check_steps,
                                  one_torch_thread,  # noqa: F401
                                  serve_reference, step_reference)

CASES = [("internvl2-26b", None)]
IDS = [case_id(a, c) for a, c in CASES]


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


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_train_loss_matches_reference(gspmd, arch, changes):
    check_loss(gspmd, arch, changes)


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_gspmd_step_matches_reference(gspmd, arch, changes):
    check_steps(gspmd, arch, "gspmd", changes)


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_butterfly_step_matches_reference(butterfly, arch, changes):
    check_steps(butterfly, arch, "butterfly", changes)


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_to_reference_round_trip(arch, changes):
    check_round_trip(arch, changes)


def test_sharded_checkpoint_restores(tmp_path):
    check_checkpoint(tmp_path, *CASES[0])
