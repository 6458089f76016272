"""The port's training path against the reference's on the CPU for the
MoE (deepseek-moe-16b: routing, the aux loss, shared experts), VLM
(paligemma-3b: prefix rows) and encoder-decoder (whisper-base: encoder
and cross attention without a mask) families, with the checks and limits
of ``test_torch_train_step.py``."""
from __future__ import annotations

import pytest

from test_torch_train_step import check_loss_and_grads, check_train_steps, setup


@pytest.fixture(scope="module", params=["deepseek-moe-16b", "paligemma-3b", "whisper-base"])
def case(request):
    return setup(request.param)


def test_loss_and_gradients_match_the_reference(case):
    check_loss_and_grads(case)


def test_train_steps_match_the_reference(case):
    check_train_steps(case)
