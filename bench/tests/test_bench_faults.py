"""The output check catches a broken timed path: a tiny run on the CPU with
the program broken underneath comes out not correct, once for each fault a
served cell can have (one chip: no exchange between chips to leave out)."""

from __future__ import annotations

import pytest
import torch

from bench.tests import _tiny


def _altered_token(monkeypatch):
    """Every sampled token of a live lane moved to the next id."""
    from repro_torch.engine import worker
    sample = worker.sample_slots

    def broken(keys, logits, cfg, active=None):
        toks = sample(keys, logits, cfg, active=active)
        return torch.where(toks >= 0, (toks + 1) % logits.shape[-1], toks)
    monkeypatch.setattr(worker, "sample_slots", broken)


def _unchanged_state(monkeypatch):
    """A decode step that returns its cache as it found it.  The slots it
    writes in the paged pool are put back rather than the pool copied whole,
    so the fault fits beside a full-size pool on the card."""
    from repro_torch.models import model as M
    step = M.decode_step

    def broken(cfg, params, cache, tokens, active=None, mesh=None):
        pos, pt = cache["pos"].clone(), cache["page_table"]
        lanes = torch.arange(len(pos), device=pos.device)
        written, states = [], []
        for _, c in M._paged_blocks(cache):
            ps = c["k"].shape[2]
            b = pt[lanes, (pos.long() // ps).clamp(max=pt.shape[1] - 1)].long()
            o = pos.long() % ps
            written.append((c, b, o, c["k"][:, b, o].clone(), c["v"][:, b, o].clone()))
        for _, c in M._state_blocks(cache):
            states.append((c, {n: t.clone() for n, t in c.items()}))
        logits, cache = step(cfg, params, cache, tokens, active=active, mesh=mesh)
        for c, b, o, k, v in written:
            c["k"][:, b, o] = k
            c["v"][:, b, o] = v
        for c, kept in states:
            c.update(kept)
        cache["pos"] = pos
        return logits, cache
    monkeypatch.setattr(M, "decode_step", broken)


def _half_batch(monkeypatch):
    """A decode step that computes the first half of the lanes and gives the
    second half the first half's logits."""
    from repro_torch.models import model as M
    step = M.decode_step

    def broken(cfg, params, cache, tokens, active=None, mesh=None):
        logits, cache = step(cfg, params, cache, tokens, active=active, mesh=mesh)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:2 * half] = logits[:half]
        return logits, cache
    monkeypatch.setattr(M, "decode_step", broken)


@pytest.mark.parametrize("fault", [_altered_token, _unchanged_state, _half_batch])
@pytest.mark.parametrize("cell", ["qwen3_8b.coding", "jamba_1period.reasoning"])
def test_a_broken_path_is_not_correct(monkeypatch, fault, cell):
    from bench import run
    fault(monkeypatch)
    result, lines = run.run_cell(_tiny.spec(cell), 11, 4.0, trace=False, device="cpu")
    assert result["correct"] is False, lines
