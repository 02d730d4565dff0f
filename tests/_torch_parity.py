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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.trajectory as jax_trajectory
import repro_torch.core.trajectory as port_trajectory
from repro.configs import get_config as jax_config
from repro.engine import runtime as JR
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.engine import runtime as TR
from repro_torch.params import from_jax

SEED = 5          # the seeded long-tail workload of the reference's trace tests
# a CLI subprocess's environment: one intra-op thread, as ``one_torch_thread``
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}
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


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread while a module runs (modules use it through
    ``pytest.mark.usefixtures``): their thousands of tiny ops gain nothing
    from a thread pool, and beside other test workers on the same cores the
    pool's threads wait on one another, which made runs many times as long.
    Results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_np(t) -> np.ndarray:
    """A tensor or a JAX array as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def tree_paths(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def jax_and_port(name, **kw):
    """(JAX config, port config, JAX params from PRNGKey(0), the same params
    as CPU tensors) of ``name`` reduced with ``kw``."""
    jcfg = jax_config(name).reduced(**kw)
    cfg = get_config(name).reduced(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def spread_records(task, rec_cls, D):
    """Hand-made records with a reward spread (the shape of
    tests/test_system.py's update test), lengths differing within each pair
    so that the policy loss is not zero at a ratio of 1; ``D`` is either
    package's ``rl.data``."""
    p = task.prompt_tokens()
    return [rec_cls(p + [D.TOOL_CALL, 20, D.EOS], 4, 1.0, 1),
            rec_cls(p + [7, D.EOS], 4, 0.0, 1),
            rec_cls(p + [D.TOOL_CALL, D.EOS], 4, 0.25, 1),
            rec_cls(p + [11, 12, D.EOS], 4, 0.0, 1)]


def hold_params(got, want, lr):
    """Whole-update tolerance: within 2 x lr, 99.9% of elements within 1e-5."""
    off, total = 0, 0
    for k, g in tree_paths(got).items():
        d = np.abs(to_np(g) - want[k])
        assert d.max() <= 2 * lr, k
        off += int((d > 1e-5).sum())
        total += d.size
    assert off <= 1e-3 * total, f"{off} of {total} elements off by more than 1e-5"
