"""The butterfly train step with the model axis inside
(``build_train_step_butterfly`` on ``SimMesh((2, 4), ("data",
"model"))``: each data group's backward tensor-parallel, each model rank's
shard synced over ``data``) against the JAX package's on ``mesh_dm``,
steps 1-3 at ``lr > 0`` for the six reduced dense and MoE configs
(``test_torch_tp_common.check_steps``: loss, ``grad_norm``, the gathered
parameters, step 1's gradient against the unsharded port, each rank's
bytes equal to the model-axis byte model plus the sync's)."""

import pytest

from test_torch_tp_common import ARCHS, check_steps, one_torch_thread, step_reference  # noqa: F401


@pytest.fixture(scope="module")
def reference(mesh_dm):
    return step_reference(mesh_dm, "butterfly")


@pytest.mark.parametrize("arch", ARCHS)
def test_butterfly_step_matches_reference(reference, arch):
    check_steps(reference, arch, "butterfly")
