"""The plain reference against the port on reduced configs, on the CPU.

The port runs its model functions (the paged pool, chunked admission,
whole-prompt admission, decode steps, absorption) in float32; the reference
runs the same fed stream whole.  Tolerance: 2e-4 of max(1, max |logit|):
both sides are float32 and differ only in the order of sums (chunked
against whole attention, the scan kernel's plain version against a
sequential loop, per-expert buffers against per-row products), a few ulps a
product over a few layers; a wrong position, mask, norm or routing moves
logits by 1e-2 or more.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from bench.tests import _tiny  # noqa: F401  (puts src on the path)
from bench import weights
from bench.reference import decoder
from bench.reference.layers import Precision

TOL = 2e-4


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= TOL * scale, f"max |err| {err} over a scale of {scale}"


def _setup(name: str, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig
    cfg = get_config(name).reduced(**kw)
    d = dataclasses.asdict(cfg)
    d["block_pattern"] = list(cfg.block_pattern)
    d["head_dim"] = cfg.hd
    model = ModelConfig(**dict(d, block_pattern=tuple(d["block_pattern"])))
    params = weights.make(model, d, 7, torch.device("cpu"))
    return model, d, params


def _stream(vocab: int, n: int, seed: int) -> list[int]:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=g).tolist()


def test_qwen3_paged_prefill_decode_extend():
    """Chunked paged admission, decode steps through the pages (lane 1 of
    3, the others masked), chunked absorption, decode again."""
    from repro_torch.models import model as M
    model, cfg, params = _setup("qwen3-8b", n_periods=2)
    ps, pages, lanes, slot = 16, 8, 3, 1
    pool = M.init_paged_pool(model, lanes, 64, ps, pages, "cpu")
    row = list(range(1 + slot * pages, 1 + (slot + 1) * pages))
    M.paged_set_lane(pool, slot, row, 0)
    stream = _stream(cfg["vocab"], 37, 1)
    C = 16
    for off in range(0, len(stream), C):
        buf = torch.zeros((1, C), dtype=torch.long)
        chunk = stream[off:off + C]
        buf[0, :len(chunk)] = torch.tensor(chunk)
        M.prefill_chunk_paged(model, params, pool, slot, buf, len(chunk))
    active = torch.arange(lanes) == slot
    got, read = [], []
    fed = stream[-1]
    for step in range(5):
        read.append(len(stream))
        stream.append(fed)
        tokens = torch.full((lanes, 1), fed)
        logits, pool = M.decode_step(model, params, pool, tokens, active=active)
        got.append(logits[slot])
        fed = int(logits[slot].argmax())
    tool = _stream(cfg["vocab"], 21, 2)
    for off in range(0, len(tool), C):
        buf = torch.zeros((1, C), dtype=torch.long)
        chunk = tool[off:off + C]
        buf[0, :len(chunk)] = torch.tensor(chunk)
        M.prefill_chunk_paged(model, params, pool, slot, buf, len(chunk))
    stream.extend(tool)
    read.append(len(stream))
    stream.append(tool[-1])
    logits, pool = M.decode_step(model, params, pool, torch.full((lanes, 1), tool[-1]),
                                 active=active)
    got.append(logits[slot])
    want = decoder.forward(params, cfg, [stream], [read], Precision("float32"), [0])[0]
    _close(torch.stack(got), want)


def test_jamba_whole_prompt_admission_then_decode():
    """Whole-prompt admission (MoE capacity over the prompt, the scan), the
    lane written into the paged pool at slot 0 of 4, decode steps."""
    from repro_torch.models import model as M
    model, cfg, params = _setup("jamba-v0.1-52b", n_periods=1)
    prompt = _stream(cfg["vocab"], 40, 3)
    S, ps, pages, lanes = len(prompt), 16, 8, 4
    logits_full, _, lane = M.forward_full(model, params, {"tokens": torch.tensor([prompt])},
                                          capacity=S)
    want_full = decoder.forward(params, cfg, [prompt], [list(range(S))],
                                Precision("float32"), [S])[0]
    _close(logits_full[0], want_full)
    pool = M.init_paged_pool(model, lanes, 64, ps, pages, "cpu")
    row = list(range(1, 1 + pages))
    M.paged_write_lane(pool, lane, 0, row, S)
    active = torch.arange(lanes) == 0
    stream, read, got = list(prompt), [], []
    fed = prompt[-1]
    for step in range(6):
        read.append(len(stream))
        stream.append(fed)
        others = torch.tensor(_stream(cfg["vocab"], lanes, 10 + step))[:, None]
        tokens = torch.where(active[:, None], torch.tensor(fed), others)
        logits, pool = M.decode_step(model, params, pool, tokens, active=active)
        got.append(logits[0])
        fed = int(logits[0].argmax())
    want = decoder.forward(params, cfg, [stream], [read], Precision("float32"), [S])[0]
    _close(torch.stack(got), want)


@pytest.mark.parametrize("prec", ["float32", "fp8"])
def test_streams_are_independent(prec):
    """Two streams at once give each stream's logits alone (padding in the
    batched scan never reaches an earlier position)."""
    model, cfg, params = _setup("jamba-v0.1-52b", n_periods=1)
    a, b = _stream(cfg["vocab"], 30, 4), _stream(cfg["vocab"], 19, 5)
    both = decoder.forward(params, cfg, [a, b], [[29], [18]], Precision(prec), [30, 19])
    alone = [decoder.forward(params, cfg, [s], [[len(s) - 1]], Precision(prec), [len(s)])[0]
             for s in (a, b)]
    for x, y in zip(both, alone):
        _close(x, y)
