"""Synthetic agentic task for the end-to-end driver (copy of ``repro/rl/data.py``).

A tiny "math agent" over a reduced vocab: the prompt encodes two operands; the agent may
emit TOOL_CALL, which invokes a calculator tool that appends the sum token to the
context; reward is 1 when the final ANSWER token matches the ground truth.  This gives
the real engine + GRPO loop genuine multi-step agentic semantics (LLM generation
interleaved with tool execution) at CPU scale.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# special tokens (vocab >= 512 in reduced configs)
PAD, BOS, TOOL_CALL, ANSWER, EOS = 0, 1, 2, 3, 4
NUM_BASE = 16            # numbers are encoded as NUM_BASE + value
MAX_VAL = 200


@dataclass(frozen=True)
class MathTask:
    a: int
    b: int

    @property
    def answer(self) -> int:
        return (self.a + self.b) % MAX_VAL

    def prompt_tokens(self) -> list[int]:
        return [BOS, NUM_BASE + self.a, NUM_BASE + self.b, ANSWER]

    def tool_result_tokens(self) -> list[int]:
        return [NUM_BASE + self.answer]

    def reward(self, generated: list[int]) -> float:
        """Shaped reward: 1.0 for producing the answer token, 0.25 for at least
        invoking the tool (dense early signal for the tiny e2e driver)."""
        target = NUM_BASE + self.answer
        if target in generated:
            return 1.0
        return 0.25 if TOOL_CALL in generated else 0.0


def sample_tasks(n: int, seed: int = 0) -> list[MathTask]:
    rng = np.random.default_rng(seed)
    return [MathTask(int(rng.integers(0, MAX_VAL // 2)), int(rng.integers(0, MAX_VAL // 2)))
            for _ in range(n)]


def pad_batch(token_lists: list[list[int]], prompt_lens: list[int], max_len: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad to (B, max_len); loss mask covers response tokens only."""
    B = len(token_lists)
    tokens = np.full((B, max_len), PAD, np.int32)
    mask = np.zeros((B, max_len), np.float32)
    for i, (toks, plen) in enumerate(zip(token_lists, prompt_lens)):
        toks = toks[:max_len]
        tokens[i, :len(toks)] = toks
        # next-token convention: position t predicts token t+1, so response tokens
        # (from plen onward) are supervised at positions plen-1 .. len-2
        mask[i, max(plen - 1, 0):max(len(toks) - 1, 0)] = 1.0
    return tokens, mask
