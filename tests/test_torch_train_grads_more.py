"""Gradients of the port's models, second half of the families (MoE,
hybrid, encoder-decoder, deepseek): the checks of
``test_torch_train_grads.py`` (``jax.grad`` against autograd, rtol 1e-4
and atol 1e-6 per leaf; remat on against off bit for bit), in a file of
their own so that the two halves run on two workers.
"""

import pytest

from test_torch_train_grads import check_grads, check_remat

ARCHS = ["deepseek-7b", "kimi-k2-1t-a32b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b",
         "whisper-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit(arch, monkeypatch):
    check_remat(arch, monkeypatch)
