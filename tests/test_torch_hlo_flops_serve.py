"""The prefill and decode steps' matrix-product flops: the port's
fake-tensor ``count_flops`` against the reference's ``dot_flops`` (plus
``prefill_corrections``) of the compiled step (``test_torch_hlo_common``),
exactly, for every arch's reduced config at batch 2, 64 tokens (decode:
one token against a 64-token cache, ``pos`` a host int on the port's
side)."""

import pytest

from repro_torch import configs
from test_torch_hlo_common import port_flops, ref_flops


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_serve_flops_match_reference(arch, kind):
    got, by_op = port_flops(arch, kind)
    assert got > 0 and set(by_op) <= {"aten.mm", "aten.bmm"}
    assert got == ref_flops(arch, kind), arch
