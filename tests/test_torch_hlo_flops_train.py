"""The train step's matrix-product flops: the port's fake-tensor
``count_flops`` against the reference's ``dot_flops`` of the compiled
``value_and_grad`` (``test_torch_hlo_common``), exactly, for the reduced
config of every arch without an SSM layer at batch 2, 64 tokens (the two
with one: ``test_torch_hlo_flops_ssm.py``)."""

import pytest

from repro_torch import configs
from test_torch_hlo_common import SSM_ARCHS, port_flops, ref_flops


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_NAMES if a not in SSM_ARCHS])
def test_train_flops_match_reference(arch):
    got, by_op = port_flops(arch, "train")
    assert got > 0 and set(by_op) <= {"aten.mm", "aten.bmm"}
    assert got == ref_flops(arch, "train"), arch
