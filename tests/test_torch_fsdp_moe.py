"""FSDP (ZeRO-3) for reduced qwen3-moe (experts split over the model axis;
Adafactor, whose factored moments reduce over dimensions FSDP splits over
the data axes): the port built with ``rules_for_mesh(mesh, fsdp=True)``
on (data 2, model 4) and on data 8
against the JAX package's FSDP runs on ``mesh_dm`` and ``mesh8``:
prefill logits and cache, teacher-forced decode and greedy tokens, the
loss, three GSPMD steps' parameters and optimizer state, every record
equal to the byte model, and the seeded layout
(``test_torch_fsdp_common``)."""

import pytest

from test_torch_fsdp_common import (check_decode, check_layout, check_loss, check_prefill,
                                    check_steps, one_torch_thread,  # noqa: F401
                                    reference)

ARCH = "qwen3-moe-235b-a22b"
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
