"""FSDP (ZeRO-3) for reduced gemma3-27b (gemma3's tied embedding (gathered
once a pass, for the embedding and the head) and its local window
periods): the port built with ``rules_for_mesh(mesh, fsdp=True)`` on (data
2, model 4) and on data 8 against the JAX package's FSDP runs on
``mesh_dm`` and ``mesh8``: prefill logits and cache, teacher-forced decode
and greedy tokens, the loss, three GSPMD steps' parameters and optimizer
state, every record equal to the byte model, and the seeded layout
(``test_torch_fsdp_common``)."""

import pytest

from test_torch_fsdp_common import (check_decode, check_layout, check_loss, check_prefill,
                                    check_steps, one_torch_thread,  # noqa: F401
                                    reference)

ARCH = "gemma3-27b"
MESH_NAMES = ("mesh_dm", "mesh8")


@pytest.fixture(scope="module")
def runs(request):
    return {name: reference(request.getfixturevalue(name), name) for name in MESH_NAMES}


@pytest.mark.parametrize("name", MESH_NAMES)
def test_seeded_layout(name):
    check_layout(ARCH, name)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_prefill_matches_reference(runs, name):
    check_prefill(runs[name], ARCH, name)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_decode_and_generate_match_reference(runs, name):
    check_decode(runs[name], ARCH, name)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_loss_matches_reference(runs, name):
    check_loss(runs[name], ARCH, name)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_gspmd_steps_match_reference(runs, name):
    check_steps(runs[name], ARCH, name)
