"""The train step's matrix-product flops of the two archs with SSM layers
(mamba2-130m, jamba-v0.1-52b): the port counts exactly the SSD scan's
gradient contractions fewer than the reference's ``dot_flops``
(``test_torch_hlo_common.ssm_train_gap``); their prefill and decode are
exact (``test_torch_hlo_flops_serve.py``)."""

import pytest

from repro_torch import configs
from test_torch_hlo_common import SSM_ARCHS, port_flops, ref_flops, ssm_train_gap


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_train_flops_differ_by_the_ssd_gap(arch):
    got, by_op = port_flops(arch, "train")
    assert got > 0 and set(by_op) <= {"aten.mm", "aten.bmm"}
    assert ref_flops(arch, "train") - got == ssm_train_gap(arch) > 0, arch


def test_ssm_gap_is_the_ssd_scan():
    """The gaps are the SSD layers' contractions: 163,840 at mamba2-130m's
    two layers, 573,440 at jamba's seven mamba layers; no other arch has an
    SSD layer."""
    assert ssm_train_gap("mamba2-130m") == 163_840
    assert ssm_train_gap("jamba-v0.1-52b") == 573_440
    assert tuple(a for a in configs.ARCH_NAMES
                 if configs.get_config(a).family in ("ssm", "hybrid")) == SSM_ARCHS
