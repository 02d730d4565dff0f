"""The output check: served tokens held against the plain float32 reference.

After the window, a sample of lanes drawn from the seed (the lane that was
served the most tokens, and one lane from each run of the pool's slots) has
every served token judged.  The
reference runs each lane's fed stream (its admission, every token its decode
steps fed and every absorbed tool token, at the positions the program put
them) and reads the logits at each position that a decode step fed.  A token
drawn at temperature T is ``argmax(logits / T + g)`` with ``g`` the step's
Gumbel noise (``reference/gumbel.py``, from the run's seed); its gap is how
far ``logits / T + g`` lies below the best of the reference's at that
position, 0 where they agree.  ``served_gap`` is the widest gap of the
sample, ``mean_gap`` the mean over its tokens (0 at each token the
reference would have drawn too), ``flip_share`` the share (%) of its tokens
with a gap above 0.  A cell's limits file names the numbers compared.

The control puts the reference in float8 e4m3 (``reference/layers.py``) in
the program's place: at the same positions of the same streams, the token
that the fp8 logits put first, judged by the same gap.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench import reference
from bench.reference import gumbel
from bench.reference.layers import Precision


def checkable(run, cfg: dict, max_slots: int) -> list:
    """Lanes whose served tokens the reference can follow alone: every lane
    that was served a token, and, under MoE, only lanes below the decode
    step's expert capacity, ``ceil(max_slots * top_k / n_experts *
    capacity_factor)``: a pair of such a lane is never dropped, whatever the
    other lanes route (an expert keeps its first pairs in lane order)."""
    lanes = [lane for lane in run.lanes.values() if lane.served]
    if any("moe" in k for k in cfg["block_pattern"]):
        cap = math.ceil(max_slots * cfg["top_k"] / cfg["n_experts"]
                        * cfg["capacity_factor"])
        lanes = [lane for lane in lanes if lane.slot < cap]
    return lanes


def sample(lanes: list, seed: int, max_lanes: int) -> list:
    """The lane served the most, and one lane drawn from ``seed`` out of each
    of ``max_lanes - 1`` runs of the others in slot order, so the sample
    spans the whole pool."""
    if not lanes:
        return []
    lanes = sorted(lanes, key=lambda lane: (lane.slot, lane.traj_id))
    first = max(lanes, key=lambda lane: len(lane.served))
    rest = [lane for lane in lanes if lane is not first]
    rng = np.random.default_rng((seed, 7))
    out = [first]
    for part in np.array_split(np.arange(len(rest)), max(max_lanes - 1, 1)):
        if len(part):
            out.append(rest[int(rng.choice(part))])
    return out


def _gaps(z: torch.Tensor, g: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """How far ``z + g`` at ``pick`` lies below its row's best."""
    s = z + g
    return s.max(dim=-1).values - s.gather(-1, pick[:, None])[:, 0]


def judge(params: dict, cfg: dict, ref_name: str, lanes: list, seed: int,
          temperature: float, control: bool = False) -> dict:
    """The sample's widest served-token gap (and with ``control`` the fp8
    control's at the same positions), the tokens judged and the seconds the
    reference took."""
    if not lanes:
        return {"served_gap": math.nan, "flip_share": math.nan, "mean_gap": math.nan,
                "tokens": 0, "lanes": 0, "seconds": 0.0, "control_gap": math.nan,
                "control_flip_share": math.nan, "control_mean_gap": math.nan}
    reference.strict_float32()
    ref = reference.load(ref_name)
    moe = any("moe" in k for k in cfg["block_pattern"])
    dev = params["tok_embed"].device
    t0 = _now(dev)
    streams, read, admitted, served, ids, pos = [], [], [], [], [], []
    for lane in lanes:
        p = [q for q, _ in lane.served]
        streams.append(lane.stream[:max(p) + 1])
        read.append(p)
        admitted.append(len(lane.request.prompt) if moe else 0)
        served.extend(t for _, t in lane.served)
        ids.extend([lane.traj_id] * len(p))
        pos.extend(p)
    with torch.no_grad():
        z = torch.cat(ref.forward(params, cfg, streams, read, Precision("float32"),
                                  admitted)) / temperature
        ctrl = (torch.cat(ref.forward(params, cfg, streams, read, Precision("fp8"),
                                      admitted)) / temperature if control else None)
        ids_t = torch.as_tensor(ids, device=dev)
        pos_t = torch.as_tensor(pos, device=dev)
        served_t = torch.as_tensor(served, device=dev)
        gap, gap_ctrl = [], []
        for s0 in range(0, len(pos), 64):
            sl = slice(s0, s0 + 64)
            g = gumbel.step_noise(seed, 0, ids_t[sl], pos_t[sl], z.shape[-1])
            gap.append(_gaps(z[sl], g, served_t[sl]))
            if control:
                gap_ctrl.append(_gaps(z[sl], g, (ctrl[sl] + g).argmax(-1)))
    gap = torch.cat(gap)
    out = {"served_gap": float(gap.max()), "mean_gap": float(gap.mean()),
           "flip_share": 100.0 * float((gap > 0).sum()) / len(pos),
           "tokens": len(pos), "lanes": len(lanes), "seconds": _now(dev) - t0}
    if control:
        gap_ctrl = torch.cat(gap_ctrl)
        out["control_gap"] = float(gap_ctrl.max())
        out["control_flip_share"] = 100.0 * float((gap_ctrl > 0).sum()) / len(pos)
        out["control_mean_gap"] = float(gap_ctrl.mean())
    return out


def _now(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()
