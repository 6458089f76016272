"""The port's training path against the reference's on the CPU for the
recurrent families, whose gradients pass the scan Functions: rwkv6-3b
(the WKV-6 scan) and recurrentgemma-9b (the RG-LRU scan and the local
attention), with the checks and limits of ``test_torch_train_step.py``."""
from __future__ import annotations

import pytest

from test_torch_train_step import check_loss_and_grads, check_train_steps, setup


@pytest.fixture(scope="module", params=["rwkv6-3b", "recurrentgemma-9b"])
def case(request):
    return setup(request.param)


def test_loss_and_gradients_match_the_reference(case):
    check_loss_and_grads(case)


def test_train_steps_match_the_reference(case):
    check_train_steps(case)
