"""The kernels' shape functions: what a kernel wrapper does on ``meta`` tensors.

A ``meta`` tensor has a shape and a dtype and no memory, so the dry run
(``launch/dryrun.py``) can run the model's step at full width on no device.
There a wrapper launches nothing: it makes empty outputs (and the scratch its
kernel takes from the caching allocator) of the kernel's shapes and dtypes,
and reports to the open tally the kernel's operations and bytes, each input
read once and each output written once, with the formulas of the kernels'
bounds in ``chip_smoke.py``, and one predicted launch.  A decode kernel's
work depends on ``valid_len``, which a ``meta`` tensor does not hold: its
shape function counts every slot valid, as they are in the dry run's caches.

``arm(name, device)`` is the one device rule of the wrappers: the plain
version on the CPU, the kernel on a card, the shape function on ``meta``,
and an error anywhere else.  ``launches`` in the wrappers' modules count
real launches only; a shape function never touches them.
"""

from __future__ import annotations

import torch

# SMs of an H100 SXM, which the decode kernels' split plan reads to size the
# workspace of a call: the layout's premise (launch/mesh.py), not a reading.
LAYOUT_SMS = 132

_tallies: list = []           # the open tallies, the innermost last


def arm(name: str, device: torch.device) -> str:
    """"plain" on the CPU, "kernel" on a CUDA device, "meta" on the meta
    device; any other device raises: there is no kernel for it."""
    if device.type in ("cpu", "meta"):
        return "plain" if device.type == "cpu" else "meta"
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    return "kernel"


def open_tally(tally) -> None:
    """Route the shape functions' reports to ``tally`` (its ``kernel(name,
    flops, nbytes, like)``) until ``close_tally``."""
    _tallies.append(tally)


def close_tally(tally) -> None:
    _tallies.remove(tally)


def report(name: str, flops: int, nbytes: int, like: torch.Tensor) -> None:
    """One predicted launch of kernel ``name`` on the device of ``like``,
    its first input: its operations and bytes, to the innermost open tally
    (to none when no dry run is open)."""
    if _tallies:
        _tallies[-1].kernel(name, flops, nbytes, like)


def decode_cost(B: int, KV: int, G: int, hd: int, tokens: int, item: int,
                pages: int = 0) -> tuple[int, int]:
    """(operations, bytes) of one decode-attention call over ``tokens``
    valid slots in all: q.k and p.v, 2 operations each a (slot, query head,
    dim); K and V of every valid slot, q and the output in ``item`` bytes,
    ``valid_len`` and the ``pages`` page-table entries read."""
    return (4 * tokens * KV * G * hd,
            2 * tokens * KV * hd * item + 2 * B * KV * G * hd * item + pages * 4 + B * 4)


def scan_cost(B: int, S: int, di: int, N: int, item: int) -> tuple[int, int]:
    """(operations, bytes) of one selective scan: 6 f32 operations a (t, d,
    n); dt and y in f32, x, B and C in ``item`` bytes, A_log and the last
    state in f32."""
    return (6 * B * S * di * N,
            B * S * di * (4 + item + 4) + 2 * B * S * N * item + di * N * 4 + B * di * N * 4)


def scan_bwd_cost(B: int, S: int, di: int, N: int, item: int) -> tuple[int, int]:
    """(operations, bytes) of one backward of the scan: 19 f32 operations a
    (t, d, n); dt, g_y and d dt in f32 and x, dx in ``item`` bytes a (b, t,
    d); B, C, dB, dC in ``item`` bytes a (b, t, n); A_log, dA_log and g_h in
    f32."""
    return (19 * B * S * di * N,
            B * S * di * (3 * 4 + 2 * item) + 4 * B * S * N * item + 2 * di * N * 4
            + B * di * N * 4)
