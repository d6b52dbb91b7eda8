"""``launch.serve_lm`` seeds its weights on the CPU and carries them to
the device: one command serves one model on every device, as the
reference's ``jax.random`` weights do (a CUDA generator draws other
numbers for a seed than the CPU's, so the card served another model than
``--device cpu`` and greedy decoding gave other tokens; ``chip_smoke.py
--coverage lm`` showed it for reduced deepseek-7b)."""

import pytest

from repro_torch import configs
from repro_torch.launch import serve_lm
from repro_torch.models import api
from test_torch_train_common import assert_trees_close


@pytest.mark.parametrize("arch", ["deepseek-7b", "whisper-medium"])
def test_seeded_model_is_the_cpu_draw(arch):
    cfg = configs.reduced(configs.get_config(arch))
    got = api.to_reference(serve_lm.seeded_model(cfg, "cpu"))
    assert_trees_close(got, api.to_reference(api.init_params(cfg, 0, device="cpu")), 0, 0)


def test_seeded_model_draws_on_the_cpu_alone(monkeypatch):
    """Whatever the device asked for, the draw is the CPU's; the weights
    reach the device through ``from_reference``."""
    seen = []
    real_init, real_from = api.init_params, api.from_reference
    monkeypatch.setattr(api, "init_params",
                        lambda cfg, seed=0, *, device: seen.append(("init", device))
                        or real_init(cfg, seed, device=device))
    monkeypatch.setattr(api, "from_reference",
                        lambda cfg, tree, *, device: seen.append(("place", device))
                        or real_from(cfg, tree, device="cpu"))
    serve_lm.seeded_model(configs.reduced(configs.get_config("olmo-1b")), "cuda")
    assert seen == [("init", "cpu"), ("place", "cuda")]
