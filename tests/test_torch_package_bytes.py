"""Package byte prices of the port's workers against the JAX workers'.

``EngineBackend`` prices a migration or a checkpoint restore from the
package's ``logical_bytes`` (the whole lane on the dense plane; resident
pages + dense state on the paged plane), so at a finite link the decision
trace depends on them.  On the dense plane with and without a sliding window
(``qwen3_1_7b`` reduced) and on the hybrid jamba worker on both planes
(``jamba_v0_1_52b`` reduced: attention KV and Mamba state), the port's
migration and checkpoint packages and ``kv_bytes`` must carry the JAX
worker's numbers.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.engine.worker import RolloutWorker as JaxWorker
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.engine.worker import RolloutWorker
from repro_torch.params import from_jax

PROMPT = [3 + i for i in range(20)]
PROMPT2 = [7, 11, 13, 5, 2, 9, 40, 41, 42, 43, 44]
CASES = {
    "qwen3-dense": ("qwen3_1_7b", None, dict(paged=False)),
    "qwen3-window": ("qwen3_1_7b", 16, dict()),          # a window forces the dense plane
    "jamba-dense": ("jamba_v0_1_52b", None, dict(paged=False)),
    "jamba-paged": ("jamba_v0_1_52b", None, dict(page_size=8)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: its thousands of tiny ops
    gain nothing from a thread pool, and beside other test workers on the
    same cores the pool's threads wait on one another, which made a run many
    times as long.  Results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prices(w0, w1):
    """Bytes of a checkpoint and a migration, before and after the move."""
    for sid, prompt in ((1, PROMPT), (2, PROMPT2)):
        w0.prefill(sid, prompt)
    w0.decode([1, 2], 3)
    out = {"kv_bytes": w0.kv_bytes(1), "checkpoint": w0.checkpoint_out(1)["logical_bytes"]}
    pkg = w0.migrate_out(2)
    out["migration"] = pkg["logical_bytes"]
    w1.migrate_in(pkg)
    w1.decode([2], 2)
    out["after_move"] = w1.checkpoint_out(2)["logical_bytes"]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_package_bytes_match_jax(case):
    arch, window, kw = CASES[case]
    jcfg, cfg = jax_config(arch).reduced(n_periods=1), get_config(arch).reduced(n_periods=1)
    if window:
        jcfg, cfg = jcfg.with_sliding_window(window), cfg.with_sliding_window(window)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(capacity=64, max_slots=2, **kw)
    want = _prices(*(JaxWorker(jcfg, jparams, worker_id=i, **kw) for i in (0, 1)))
    got = _prices(*(RolloutWorker(cfg, params, worker_id=i, device="cpu", **kw)
                    for i in (0, 1)))
    assert got == want
    assert min(got.values()) > 0
