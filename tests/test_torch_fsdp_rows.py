"""The dry run's production rows of the six FSDP configs (deepseek-7b,
gemma3-27b, qwen3-moe, kimi-k2, internvl2-26b, jamba-52b) at their
published sizes on the production mesh (data 16 x model 16) under fake
tensors: each config's ``decode_32k`` row is ``ok``, and its collectives
are the FSDP term (``lm.fsdp_calls``: every split leaf gathered where it
is used) beside the model axis's (``lm.tp_calls``), call for call."""

import pytest

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.dist.sharding import rules_for_mesh
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from test_torch_tp_common import one_torch_thread  # noqa: F401

FSDP_ARCHS = ("deepseek-7b", "gemma3-27b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
              "internvl2-26b", "jamba-v0.1-52b")


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_production_decode_row_has_its_fsdp_term(arch, tmp_path):
    cfg = configs.get_config(arch)
    assert cfg.fsdp
    rec = dryrun.run_lm_cell(arch, "decode_32k", False, str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    mesh = make_production_mesh(multi_pod=False)
    rules = rules_for_mesh(mesh, fsdp=True)
    shape = SHAPES["decode_32k"]
    data, size = mesh.shape["data"], mesh.shape["model"]
    fsdp = lm.tp_stats(lm.fsdp_calls(cfg, "decode", mesh, rules), data)
    tp = lm.tp_stats(lm.tp_calls(cfg, "decode", shape.global_batch // data, shape.seq_len,
                                 size), size)
    assert fsdp["all-gather"]["count"] > 0
    assert rec["collectives"] == hlo_stats.total_stats([fsdp, tp])
    assert rec["t_collective"] > 0.0
