"""Shared set-up of the port's control-plane and runtime parity tests.

Trajectory ids come from a process-global counter in each package, and tool
outcomes and prompts are seeded by them; ``same_ids`` starts both counters at
one value so the two packages build the same workload.  The predictor's fit
differs by design (the JAX package solves in f32, the port in float64), so
``workbench`` copies the JAX predictor's fitted state into the port's.
"""

import contextlib
import copy
import itertools

import repro.core.trajectory as jax_trajectory
import repro_torch.core.trajectory as port_trajectory
from repro.engine import runtime as JR
from repro_torch.engine import runtime as TR

SEED = 5          # the seeded long-tail workload of the reference's trace tests
PREDICTOR_STATE = ("weights", "_scale", "_resid_var", "hist_max_tokens", "hist_lengths")


@contextlib.contextmanager
def same_ids(start: int = 0):
    """Both packages' trajectory-id counters from ``start``, restored after."""
    saved = jax_trajectory._traj_counter, port_trajectory._traj_counter
    jax_trajectory._traj_counter = itertools.count(start)
    port_trajectory._traj_counter = itertools.count(start)
    try:
        yield
    finally:
        jax_trajectory._traj_counter, port_trajectory._traj_counter = saved


def copy_predictor_state(src, dst):
    for name in PREDICTOR_STATE:
        setattr(dst, name, copy.deepcopy(getattr(src, name)))
    return dst


def workbench(**kw):
    """``build_workbench`` in both packages: ((jax batch, jax predictor),
    (port batch, port predictor holding the JAX fit))."""
    kw = {"n_prompts": 6, "group_size": 4, "seed": SEED, **kw}
    with same_ids():
        jb, jp = JR.build_workbench(**kw)
        tb, tp = TR.build_workbench(**kw)
    return (jb, jp), (tb, copy_predictor_state(jp, tp))


def rcfg(mod, **kw):
    """The reference harness's RuntimeConfig (tests/test_orchestrator.py) in
    package ``mod``'s runtime module, with overrides."""
    base = dict(scheduler="pps", migration=True, max_active=2, quantum=8,
                link_bandwidth=float("inf"), trace=True, seed=SEED, sanitize=True)
    base.update(kw)
    return mod.RuntimeConfig(**base)
