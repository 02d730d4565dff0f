"""The port's decode profiler (paper §5.2's F(batch)) against the JAX package's.

The profile is a timing, so the two packages cannot give equal numbers; what
must agree is what each makes of a profile.  A CPU profile times PyTorch's
CPU kernels and says nothing of the card.
"""

import pytest
import torch

import repro.engine.profiler as JP
import repro_torch.engine.profiler as TP
from repro_torch.configs import get_config
from repro_torch.core.placement import presorted_dp
from repro_torch.models import model as M

KW = dict(batch_sizes=(1, 2, 4), capacity=64, context=16, steps=2, warmup=1)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    return cfg, M.init_params(cfg, seed=0, device="cpu")


def test_profiler_produces_monotone_interference(setup):
    """tests/test_worker.py's check on the port: one key per batch size, every
    time > 0, F(1) = 1, F monotone, and F feeds the placement DP."""
    cfg, params = setup
    prof = TP.profile_decode(cfg, params, device="cpu", **KW)
    assert set(prof) == {1, 2, 4}
    assert all(v > 0 for v in prof.values())
    F = TP.measured_interference(cfg, params, device="cpu", **KW)
    assert F(1) == 1.0
    assert F(4) >= F(2) >= F(1)
    res = presorted_dp([100.0, 50, 10, 5], 2, F)
    assert res.makespan > 0


def test_measured_interference_matches_jax_on_one_profile(monkeypatch):
    """With both packages' ``profile_decode`` returning the same
    non-monotone profile, the port's F equals the JAX one's at every batch
    (the running max, then the interpolated table), as does the port's
    ``interference_from_profile`` of that profile."""
    profile = {1: 2.0e-3, 2: 1.9e-3, 4: 2.6e-3, 8: 2.4e-3, 16: 4.1e-3}
    monkeypatch.setattr(JP, "profile_decode", lambda *a, **k: dict(profile))
    monkeypatch.setattr(TP, "profile_decode", lambda *a, **k: dict(profile))
    jf, tf = JP.measured_interference(None, None), TP.measured_interference(None, None)
    direct = TP.interference_from_profile(dict(profile))
    for b in [0, 1, 1.5, 2, 3, 4, 6, 8, 12, 16, 20]:
        assert tf(b) == jf(b) == direct(b), b
    assert tf(2) == 1.0 and tf(8) == tf(4) == pytest.approx(1.3)


def test_profiler_runs_on_the_card_unless_asked(setup, monkeypatch):
    """``device=None`` is the card: where there is none it raises before
    timing anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.profile_decode(cfg, params, **KW)
