"""The port's synthetic token stream (``repro_torch.data.synthetic``)
against the reference's: batches and frontend stubs equal bit for bit."""
from __future__ import annotations

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data.synthetic import DataConfig as RefDataConfig
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.data.synthetic import frontend_stubs as ref_frontend_stubs
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM, frontend_stubs
from repro_torch.models.config import reduce_for_smoke

#: a dense, a VLM (prefix rows) and an encoder-decoder (frames) config
ARCHS = ["gemma3-1b", "paligemma-3b", "whisper-base"]


def _same(port: dict, ref: dict):
    assert port.keys() == ref.keys()
    for name, want in ref.items():
        assert port[name].dtype == want.dtype, name
        assert np.array_equal(port[name], want), name


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_the_reference(arch, smoke):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    if smoke:
        ref_cfg, cfg = ref_reduce_for_smoke(ref_cfg), reduce_for_smoke(cfg)
    data = dict(global_batch=3, seq_len=24, seed=5)
    port = SyntheticLM(cfg, DataConfig(**data))
    ref = RefSyntheticLM(ref_cfg, RefDataConfig(**data))
    assert np.array_equal(port.active, ref.active)
    assert np.array_equal(port.next_tbl, ref.next_tbl)
    got = list(port.batches(3))
    want = list(ref.batches(3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
        assert np.array_equal(g["tokens"][:, 1:], g["targets"][:, :-1])
    extra = {"vision_stub": {"prefix_embed"}, "audio_stub": {"frames"}}.get(cfg.frontend, set())
    assert set(got[0]) == {"tokens", "targets"} | extra


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_stubs_equal_the_reference(arch):
    cfg, ref_cfg = reduce_for_smoke(get_config(arch)), ref_reduce_for_smoke(ref_get_config(arch))
    for seed in (0, 3):
        _same(frontend_stubs(cfg, 2, seed=seed), ref_frontend_stubs(ref_cfg, 2, seed=seed))


def test_an_endless_stream_starts_as_a_finite_one():
    cfg = reduce_for_smoke(get_config("llama3.2-3b"))
    data = SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=8))
    endless = data.batches()
    for want in data.batches(4):
        _same(next(endless), want)
