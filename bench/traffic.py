"""The one traffic generator: a mix file of parameters in, plain plans and token ids out.

A mix is ``bench/traffic/<name>.json``.  Its ``plan`` names one of two plan
models, both read from the file's numbers alone:

  * ``agentic``: GRPO groups of multi-step trajectories with tool calls, a
    frozen copy of the port's ``engine/workload.py::generate`` and
    ``engine/tools.py::ToolProfile`` (the paper's long-tail statistics), with
    the task shape and the tool profile given as data, the generated tokens of
    each step scaled by ``gen_scale``, and a shared system prompt before each
    task prompt;
  * ``single_step``: GRPO groups of one generation each, prompt lengths
    uniform over a range, output lengths lognormal with a cap.

Sizes (prompt lengths, steps, generated and tool tokens, tool latencies)
come from ``(plan_seed, batch)`` only, so every ``--seed`` gets the same
batches in the same order (the runtime's virtual clock then makes the same
decisions); ``(seed, batch)`` draws every token id.  The program receives
only what this module returns.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load_mix(name: str) -> dict:
    """The mix file ``bench/traffic/<name>.json``."""
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r}: {path} is missing")
    return json.loads(path.read_text())


@dataclass
class Plan:
    """One trajectory's sizes: per step its generated tokens, tool latency
    (virtual seconds), tool failure and tool output tokens."""

    gen: list[int]
    tool_latency: list[float]
    tool_failed: list[bool]
    tool_out: list[int]


@dataclass
class Request:
    """One trajectory as the harness hands it to the program."""

    index: int                     # position in the batch
    group: int                     # GRPO group (prompt) id
    sample: int                    # sample within the group
    prompt: list[int]              # system prompt + task prompt ids
    plan: Plan
    tool_ids: list[list[int]] = field(default_factory=list)   # per step


# ------------------------------------------------------------------ agentic plans
# A frozen copy of engine/workload.py::generate and engine/tools.py::ToolProfile.

def _tool_latency(tool: dict, rng: np.random.Generator) -> float:
    sigma = np.sqrt(np.log(1 + tool["cv"] ** 2))
    mu = np.log(tool["mean_latency"]) - sigma ** 2 / 2
    return float(rng.lognormal(mu, sigma))


def _tool_tokens(tool: dict, rng: np.random.Generator, failed: bool) -> int:
    base = tool["output_tokens_mean"] * (2.0 if failed else 1.0)
    return int(max(1, rng.normal(base, base * 0.3)))


def _agentic_groups(mix: dict, rng: np.random.Generator) -> list[tuple[int, list[Plan]]]:
    steps_mult, tok_mult, spread = (mix["task"][k] for k in ("steps_mult", "tok_mult",
                                                            "spread"))
    tool = mix["tool"]
    groups = []
    for _ in range(mix["n_prompts"]):
        difficulty = rng.lognormal(0.0, mix["difficulty_sigma"])
        prompt_tokens = int(np.clip(rng.normal(120 + 60 * difficulty, 40), 16, 2048))
        plans = []
        for _ in range(mix["group_size"]):
            sample_luck = rng.lognormal(0.0, 0.6 * spread)
            hardness = difficulty * sample_luck
            gen, lat, fail, touts = [], [], [], []
            fail_p = min(0.85, tool["fail_rate"] * (0.4 + 0.6 * hardness))
            base_n = mix["base_steps"] + steps_mult * hardness
            n_steps = int(np.clip(round(rng.lognormal(np.log(base_n), 0.22)), 1, 64))
            total, s = 0, 0
            while True:
                scale = (0.5 + 0.7 * hardness) if s == 0 else (0.9 + 0.1 * hardness)
                g = int(np.clip(rng.lognormal(
                    np.log(mix["mean_step_tokens"] * tok_mult * scale), 0.35), 8, 8192))
                g = min(g, max(mix["max_output_tokens"] - total, 8))
                total += g
                failed = bool(rng.random() < fail_p)
                if failed:
                    n_steps = min(n_steps + 1, 64)
                gen.append(g)
                lat.append(_tool_latency(tool, rng))
                touts.append(int(_tool_tokens(tool, rng, failed) * (0.7 + 0.35 * hardness)))
                s += 1
                stop = total >= mix["max_output_tokens"] or s >= n_steps
                fail.append(failed and not stop)
                if stop:
                    break
            scale = mix["gen_scale"]
            plans.append(Plan([max(1, round(g * scale)) for g in gen], lat, fail, touts))
        groups.append((prompt_tokens, plans))
    return groups


# ------------------------------------------------------------------ single-step plans

def _single_step_groups(mix: dict, rng: np.random.Generator
                        ) -> list[tuple[int, list[Plan]]]:
    lo, hi = mix["prompt_tokens"]["uniform"]
    out = mix["output_tokens"]
    groups = []
    for _ in range(mix["n_prompts"]):
        prompt_tokens = int(rng.integers(lo, hi + 1))
        plans = []
        for _ in range(mix["group_size"]):
            g = rng.lognormal(np.log(out["median"]), out["sigma"])
            n = int(min(out["max"], max(1, round(g))))
            plans.append(Plan([n], [0.0], [False], [0]))
        groups.append((prompt_tokens, plans))
    return groups


_PLANS = {"agentic": _agentic_groups, "single_step": _single_step_groups}


def _fit(prompt_len: int, plan: Plan, capacity: int) -> Plan:
    """Cut a plan at the last step whose context still fits ``capacity``
    lane slots (prompt + generated + tool tokens); the cut step ends the
    trajectory."""
    ctx = prompt_len
    for s, (g, o) in enumerate(zip(plan.gen, plan.tool_out)):
        if ctx + g + o > capacity:
            if s == 0:
                raise ValueError(f"a first step of {g} tokens after a prompt of "
                                 f"{prompt_len} does not fit a lane of {capacity}")
            n = s
            return Plan(plan.gen[:n], plan.tool_latency[:n],
                        plan.tool_failed[:n - 1] + [False], plan.tool_out[:n])
        ctx += g + o
    return plan


def plan_groups(mix: dict, batch: int) -> list[tuple[int, list[Plan]]]:
    """Batch ``batch``'s groups as (task prompt tokens, plans), from the
    mix's own ``plan_seed``: the same for every run seed."""
    rng = np.random.default_rng((mix["plan_seed"], batch))
    groups = _PLANS[mix["plan"]](mix, rng)
    system = mix.get("system_prompt_tokens", 0)
    return [(p, [_fit(system + p, plan, mix["capacity"]) for plan in plans])
            for p, plans in groups]


def make_batch(mix: dict, seed: int, batch: int, vocab: int) -> list[Request]:
    """Batch ``batch`` of run ``seed``: the mix's sizes, with every token id
    drawn from ``(seed, batch)``.  The system prompt is the run's one
    sequence, before every task prompt; a group shares its task prompt."""
    rng = np.random.default_rng((seed, batch))
    system = np.random.default_rng((seed, 1 << 20)).integers(
        0, vocab, mix.get("system_prompt_tokens", 0)).tolist()
    out: list[Request] = []
    for g, (prompt_len, plans) in enumerate(plan_groups(mix, batch)):
        task = rng.integers(0, vocab, prompt_len).tolist()
        for j, plan in enumerate(plans):
            tools = [rng.integers(0, vocab, n).tolist() for n in plan.tool_out]
            out.append(Request(len(out), g, j, system + task, plan, tools))
    return out


def history(mix: dict) -> list[tuple[int, Plan]]:
    """The predictor's history: (prompt tokens, plan) of ``history_prompts``
    groups drawn at ``plan_seed + 10_000``, the harness's counterpart of
    ``build_workbench``'s disjoint history."""
    rng = np.random.default_rng(mix["plan_seed"] + 10_000)
    hist = dict(mix, n_prompts=mix.get("history_prompts", mix["n_prompts"]))
    system = mix.get("system_prompt_tokens", 0)
    return [(system + p, _fit(system + p, plan, mix["capacity"]))
            for p, plans in _PLANS[mix["plan"]](hist, rng) for plan in plans]
