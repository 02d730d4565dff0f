"""The harness end to end at a tiny size on the CPU: the result line, the
window's cut, the counts of attempted and failed; the entry point's refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench.tests import _tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["qwen3_8b.coding", "jamba_1period.reasoning"])
def test_a_tiny_run(cell):
    from bench import run
    spec = _tiny.spec(cell)
    seconds = 4.0
    result, lines = run.run_cell(spec, 3_000_000_017, seconds, trace=False, device="cpu")
    assert list(result) == KEYS                      # the checks come last
    assert result["correct"] is True, lines
    assert result["failed"] == 0
    assert result["attempted"] > 0
    names = {m["name"] for m in spec["end_to_end"]}
    assert set(result["metrics"]) == names
    assert all(m["value"] > 0 for m in result["metrics"].values())
    judged = result["checks"]["tokens_judged_at_least"]
    assert judged["value"] >= spec["limits"]["min_tokens"]
    json.dumps(result)


def test_the_window_ends_at_the_first_call_past_its_seconds():
    from bench import harness, traffic
    spec = _tiny.spec("qwen3_8b.coding")
    h = harness.Harness(spec["cfg_file"]["model"], spec["mix"], 5, "cpu", False,
                        spec["cfg_file"]["serve"]["num_blocks"])
    h.warm()
    rec = h.window(1.0, 0.0)
    calls = [s for s in rec.spans if s[0] != "bookkeeping"]
    assert rec.window_s >= 1.0
    assert calls[-1][2] == pytest.approx(rec.window_s)      # the cut call ends the window
    assert all(b < 1.0 for _, _, b in calls[:-1])           # earlier calls ended inside
    admitted = [lane for lane in rec.lanes.values() if lane.admitted]
    assert rec.attempted == len(admitted) > 0
    mix = spec["mix"]
    assert len(rec.lanes) == rec.batches * mix["n_prompts"] * mix["group_size"]
    assert rec.generated == sum(len(lane.served) for lane in rec.lanes.values())
    assert sum(c for _, c in rec.tpot) == rec.generated
    for lane in admitted:
        plan = lane.request.plan.gen
        assert lane.steps == plan[:len(lane.steps)]
        assert len(lane.stream) == len(lane.ctx)            # a position a token
    assert traffic.make_batch(mix, 5, 0, 512)[0].prompt == rec.lanes[0].request.prompt


def test_a_lane_that_decodes_too_much_fails():
    from bench import harness
    spec = _tiny.spec("qwen3_8b.coding")
    h = harness.Harness(spec["cfg_file"]["model"], spec["mix"], 5, "cpu", False,
                        spec["cfg_file"]["serve"]["num_blocks"])
    h.warm()
    rec = h.window(0.5, 0.0)
    lane = next(lane for lane in rec.lanes.values() if lane.admitted)
    rec.failed = rec.attempted = 0
    lane.step_tokens = lane.request.plan.gen[0] + 1
    h._judge_counts()
    assert rec.failed == 1


def _entry(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "bench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


ARGS = ("--workload", "qwen3_8b.coding", "--seed", "1", "--seconds", "1", "--trace", "0")


def test_no_card_no_result():
    out = _entry(_tiny.ROOT, *ARGS)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(_tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(_tiny.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _entry(tmp_path, *ARGS)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_that_judges_nothing_is_not_correct():
    """A window cut at the first admission serves no token: no reading, a
    null beside the limit, and a valid JSON line."""
    from bench import run
    result, lines = run.run_cell(_tiny.spec("qwen3_8b.coding"), 5, 0.0, trace=False,
                                 device="cpu")
    assert result["correct"] is False
    assert result["checks"]["served_gap"]["value"] is None
    assert result["checks"]["tokens_judged_at_least"]["value"] == 0
    json.dumps(result, allow_nan=False)
