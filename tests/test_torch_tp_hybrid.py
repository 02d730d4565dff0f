"""Tensor-parallel workers of the hybrid, MoE and ring configs, every shard on
the CPU, against the JAX worker and the port's degree-1 worker.

The script, its tolerance and its helpers are ``tests/test_torch_tp.py``'s:
sibling admissions, decode at temperature 1 / top-p 0.9, a tool extension,
preempt and resume; the tokens, block ids and dispatch counters must be the
JAX worker's, and a teacher-forced decode step's logits must lie within
``LOGIT_TOL`` of the JAX worker's and of the degree-1 worker's.  Every config
here admits by one full forward (MoE is not chunk-safe, a ring wraps, or
``use_chunked=False``), so the sharded worker's admission is
``forward_full(mesh=)`` and its tool tokens are absorbed one masked decode
step each:

  * jamba (``jamba_v0_1_52b.reduced(n_periods=1)``, f32: 7 Mamba layers, 1
    attention layer, 4 MoE layers of 4 experts) paged at degree 2 and 4 and
    dense at 2;
  * qwen2-moe (the gated shared experts) paged at 2 and dense at 4, arctic
    (the dense residual) paged at 2;
  * qwen3 reduced with a 16-token window (dense by force; 20-token prompts
    wrap the ring) at 2, and qwen3 with ``use_chunked=False`` paged at 2.

Then a jamba lane migrated d2 -> d1 -> d4 -> d2 (every package, KV pages
and Mamba state, bit-equal to the first), a {2, 1, 1} runtime on qwen2-moe
against the JAX runtime's decision trace, and the serve CLI on jamba with
``--degrees 2,1,1`` over four CPU devices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import runtime as JR
from repro.engine.fleet import FleetSpec as JaxFleetSpec
from repro.engine.sampler import SamplerConfig as JaxSampler
from repro.engine.worker import RolloutWorker as JaxWorker
from repro.models import model as JM
from repro_torch.engine import runtime as TR
from repro_torch.engine.fleet import FleetSpec
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import model as M

from _torch_parity import (jax_and_port, one_torch_thread, rcfg, same_ids,  # noqa: F401
                           to_np, workbench)
from test_torch_tp import (KW, LOGIT_TOL, PROMPT, _mesh, _payload, _result, _script,
                           _serve, _tokens, _worker)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODELS = {"jamba": ("jamba_v0_1_52b", dict(n_periods=1), {}),
          "qwen2_moe": ("qwen2_moe_a2_7b", dict(n_periods=1), {}),
          "arctic": ("arctic_480b", dict(n_periods=1), {}),
          "qwen3-window": ("qwen3_1_7b", dict(n_periods=2), dict(capacity=16)),
          "qwen3-unchunked": ("qwen3_1_7b", dict(n_periods=2), dict(use_chunked=False))}
CASES = [("jamba", "paged", 2), ("jamba", "paged", 4), ("jamba", "dense", 2),
         ("qwen2_moe", "paged", 2), ("qwen2_moe", "dense", 4), ("arctic", "paged", 2),
         ("qwen3-window", "dense", 2), ("qwen3-unchunked", "paged", 2)]
WINDOW = 16


def _configs(model):
    name, reduce, kw = MODELS[model]
    jcfg, cfg, jparams, params = jax_and_port(name, **reduce)
    if model == "qwen3-window":
        jcfg, cfg = jcfg.with_sliding_window(WINDOW), cfg.with_sliding_window(WINDOW)
    return jcfg, cfg, jparams, params, dict(KW, **kw)


@pytest.fixture(scope="module")
def refs():
    """(model, plane) -> (JAX script, JAX logits, port degree-1 script and
    logits, config, params, worker keywords), built once each."""
    cache = {}

    def get(model, plane):
        if (model, plane) not in cache:
            jcfg, cfg, jparams, params, kw = _configs(model)
            paged = plane == "paged"
            jw = JaxWorker(jcfg, jparams, sampler=JaxSampler(1.0), paged=paged, **kw)
            one = RolloutWorker(cfg, params, sampler=SamplerConfig(1.0), paged=paged,
                                device="cpu", **kw)
            jout, oout = _script(jw), _script(one)
            toks = _tokens(one)
            jlogits, _ = JM.decode_step(jcfg, jparams, jw.pool, jnp.asarray(toks))
            ologits, _ = M.decode_step(cfg, one.params, one.pool, torch.from_numpy(toks))
            cache[model, plane] = (jout, to_np(jlogits), oout, to_np(ologits), cfg, params, kw)
        return cache[model, plane]

    return get


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}-d{c[2]}")
def case(request, refs):
    model, plane, d = request.param
    jout, jlogits, oout, ologits, cfg, params, kw = refs(model, plane)
    w = RolloutWorker(cfg, params, sampler=SamplerConfig(1.0), paged=plane == "paged",
                      mp=d, mesh=_mesh(d), **kw)
    out = _script(w)
    logits, _ = M.decode_step(cfg, w.params, w.pool, torch.from_numpy(_tokens(w)), mesh=w._tp)
    return w, out, to_np(logits), jout, jlogits, oout, ologits


def test_sharded_worker_matches_jax_worker(case):
    w, out, _, jout, _, oout, _ = case
    assert not w._chunked                        # admitted by forward_full(mesh=)
    assert out == jout                            # tokens, block ids, counters
    assert out == oout
    stats = w.dispatch_stats()
    assert stats["mesh_devices"] == stats["mp"] == w.mp


def test_sharded_logits_within_tolerance(case):
    w, _, logits, _, jlogits, _, ologits = case
    lanes = sorted(seq.slot for seq in w.store.values())
    assert np.abs(logits[lanes] - jlogits[lanes]).max() <= LOGIT_TOL
    assert np.abs(logits[lanes] - ologits[lanes]).max() <= LOGIT_TOL


def test_shards_hold_their_part(case):
    """Each shard holds 1/d of the experts, of Mamba's channels and of their
    state, and of the kv heads, on its device."""
    w = case[0]
    d, cfg, split = w.mp, w.cfg, w.split
    assert len(w.params) == len(w.pool) == d
    for p, pool in zip(w.params, w.pool):
        for key, c in pool["blocks"].items():
            if key[3:].startswith("mamba"):
                assert c["h"].shape[-2] == c["conv"].shape[-1] == cfg.d_inner // d, key
                assert p["blocks"][key]["mixer"]["m_in"].shape[-1] == cfg.d_inner // d
            else:
                assert c["k"].shape[-2] == cfg.n_kv_heads // d, key
            if "+moe" in key:
                assert p["blocks"][key]["mlp"]["we_in"].shape[1] == cfg.n_experts // d
                assert p["blocks"][key]["mlp"]["router"].shape[-1] == cfg.n_experts
    assert split.experts == (cfg.n_experts > 0)


@pytest.fixture(scope="module")
def jamba():
    _, cfg, _, params, _ = _configs("jamba")
    return cfg, params


@pytest.mark.parametrize("plane", ["paged", "dense"])
def test_jamba_migration_crosses_degrees_bit_equal(jamba, plane):
    """A jamba lane moves d2 -> d1 -> d4 -> d2: every package (the K/V pages
    or lane and the Mamba state, in the full layout on the host), and a
    checkpoint of the last, is bit-equal to the first, and the lane decodes
    on as an unmigrated one."""
    cfg, params = jamba
    paged = plane == "paged"
    ref = _worker(cfg, params, 1, paged=paged)
    hops = [_worker(cfg, params, d, wid=i, paged=paged) for i, d in enumerate((2, 1, 4, 2))]
    for w in (ref, hops[0]):
        w.prefill(7, PROMPT)
    straight = ref.decode([7], 12)[7]
    first = hops[0].decode([7], 4)[7]
    pkg = hops[0].migrate_out(7)
    want = _payload(pkg)
    assert any(k.endswith("/h") for k in want) and any(k.endswith("/conv") for k in want)
    assert all(t.device == torch.device("cpu") for t in want.values())
    for src, dst in zip(hops, hops[1:]):
        if src is not hops[0]:
            got = _payload(pkg := src.migrate_out(7))
            assert got.keys() == want.keys()
            for name, t in want.items():
                assert got[name].dtype == t.dtype and torch.equal(got[name].cpu(), t), name
        dst.migrate_in(pkg)
    ck = _payload(hops[-1].checkpoint_out(7))             # a host copy; the lane stays
    assert ck.keys() == want.keys() and all(torch.equal(ck[k], t) for k, t in want.items())
    assert first + hops[-1].decode([7], 8)[7] == straight


def test_runtime_on_a_sharded_moe_fleet_matches_jax_trace():
    """A {2, 1, 1} qwen2-moe fleet over four CPU devices (worker 0 on two
    shards, its experts cut) gives the JAX runtime's decision trace."""
    plane = dict(paged=None, link_bandwidth=2e9)
    jcfg, cfg, jparams, params = jax_and_port("qwen2_moe_a2_7b", n_periods=1)
    (jb, jp), (tb, tp) = workbench()
    with same_ids():
        want = JR.make_runtime(jcfg, jparams, jb, jp, config=rcfg(JR, **plane),
                               fleet=JaxFleetSpec((2, 1, 1))).run()
    with same_ids():
        rt = TR.make_runtime(cfg, params, tb, tp, config=rcfg(TR, **plane),
                             fleet=FleetSpec((2, 1, 1)), device="cpu", devices=["cpu"] * 4)
        assert [w.mesh.degree for w in rt.fleet.workers] == [2, 1, 1]
        assert rt.fleet.workers[0].split.experts
        got = rt.run()
    assert got.preemptions > 0 and len(got.trace) > 0
    assert _result(got) == _result(want)
    assert got.worker_stats[0]["mesh_devices"] == 2


def test_serve_cli_shards_jamba_over_devices():
    out = _serve("--arch", "jamba-v0.1-52b", "--device", "cpu", "--devices",
                 "cpu,cpu,cpu,cpu", "--degrees", "2,1,1", "--requests", "8", "--steps", "2")
    assert out.returncode == 0, out.stderr
    assert "worker 0 (MP 2 over 2 devices)" in out.stdout and "worker 2 (MP 1)" in out.stdout
    assert "served 8 trajectories on cpu" in out.stdout
