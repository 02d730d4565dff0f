#!/usr/bin/env python3
"""Check PyTorch's elementwise ops that the kernel holds use, on every card
other than cuda:0, against the same ops on the host.

    python3 tools/ldexp_cards.py

The scan backward's hold (``chip_smoke._hold_scan_bwd``,
``tests/_torch_hold.py::hold_bf16_cast``) computes half a bf16 ulp of each
value with ``torch.frexp`` and ``torch.ldexp``.  For each card ``cuda:c``,
c >= 1, this prints how many elements of ``frexp``'s mantissa and exponent,
``ldexp``, ``abs`` and a subtraction, computed on the card, differ from the
host's, on 8,388,608 f32 values drawn on the host (the size of one jamba
shard's d dt at S 2,048): first inside ``torch.cuda.device(c)`` for every
card, then with cuda:0 the current device (as a wrapper handed tensors on
another card runs), ``ldexp`` last.  A CUDA error ends the check (the
process's context is lost): it is printed with the op that raised it.
Exits 1 where anything differs or raised.
"""

from __future__ import annotations

import sys

import torch

N_VALUES = 1 << 23
OPS = {"frexp mantissa": lambda w: torch.frexp(w)[0],
       "frexp exponent": lambda w: torch.frexp(w)[1],
       "abs": lambda w: w.abs(), "sub": lambda w: w - 0.5,
       "ldexp": lambda w: torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 9)}


def main() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        print(f"ldexp_cards: {n} card visible, needs two or more", file=sys.stderr)
        return 2
    w = torch.randn(N_VALUES, generator=torch.Generator().manual_seed(0)) * 30
    want = {k: op(w) for k, op in OPS.items()}
    bad = 0
    for current in ("the card", "cuda:0"):
        for card in range(1, n):
            dev = torch.device("cuda", card)
            there = w.to(dev)
            torch.cuda.synchronize(card)
            diffs = {}
            for k, op in OPS.items():
                try:
                    with torch.cuda.device(dev if current == "the card" else 0):
                        got = op(there)
                    torch.cuda.synchronize(card)
                    diffs[k] = int((got.cpu() != want[k]).sum())
                except RuntimeError as e:
                    print(f"cuda:{card}, {current} current: {k} raised {str(e).splitlines()[0]}",
                          flush=True)
                    return 1
            bad += sum(diffs.values())
            print(f"cuda:{card}, {current} current: elements differing from the host: "
                  + ", ".join(f"{k} {d}" for k, d in diffs.items()), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
