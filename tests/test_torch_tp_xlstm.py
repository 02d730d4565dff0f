"""The tensor-parallel xLSTM split, every shard on the CPU, against the JAX
package.

``xlstm_350m.reduced(n_periods=1)`` (f32; d 256, 4 heads, the mLSTM's inner
width 512 at head width 128, the sLSTM's head width 64, vocab 512: the
xLSTM and the vocabulary cut at degree 2 and 4), with the JAX
``init_params`` pytree carried across by ``from_jax`` and inputs drawn with
numpy:

  * the mLSTM's full and step forms on 2 and 4 shards: each shard's partial
    q/k/v/gate products summed before the cell, the cell on its H/d heads,
    the partial ``l_down`` products summed, against JAX ``mlstm_full`` /
    ``mlstm_step``, and the shards' states gathered on the heads against
    the JAX state extractor; the sLSTM's likewise (no sum before its cell);
  * ``forward_full(mesh=)``, then ``decode_step(mesh=)``, and chunked
    prefill on a mesh into a dense lane and a paged lane's state row,
    against the JAX functions;
  * paged (a pure-state pool) and dense xLSTM workers at degree 2 and 4,
    through ``tests/test_torch_tp.py``'s script: tokens, block ids and
    counters equal to the JAX worker's and the port's degree-1 worker's,
    a teacher-forced step's logits within ``LOGIT_TOL`` of both;
  * a lane moved d2 -> d1 -> d4 -> d2, every package bit-equal to the first,
    a fleet whose reconfiguration moves an xLSTM resident across degrees,
    and the serve CLI with ``--degrees 2,1`` over three CPU devices.

Tolerances are ``tests/test_torch_tp_mixers.py``'s: 2e-5 for a layer's
output and state (f32 sums in another order; the shards' partials add one
more reordering), and ``LOGIT_TOL`` (5e-6) for logits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.sampler import SamplerConfig as JaxSampler
from repro.engine.worker import RolloutWorker as JaxWorker
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.distributed.sharding import (gather_cache, shard_cache, shard_config,
                                              shard_params, tp_split)
from repro_torch.engine.fleet import FleetSpec
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import model as M

from _torch_parity import jax_and_port, one_torch_thread, to_np  # noqa: F401
from test_torch_tp import (KW, LOGIT_TOL, PROMPT, _fleet, _mesh, _payload, _script,
                           _serve, _tokens, _worker)
from test_torch_tp_mixers import _close, _layer

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MLSTM, SLSTM = "00_mlstm", "05_slstm"
STATE = {MLSTM: ("C", "n", "m"), SLSTM: ("h", "c", "n", "m")}


@functools.cache
def _model():
    """(JAX config, port config, JAX params, port params), built once."""
    return jax_and_port("xlstm_350m", n_periods=1)


def _split(cfg, d):
    split = tp_split(cfg, d)
    return split, shard_config(cfg, split), _mesh(d)


def _inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_state(key, jcfg, jp, x):
    """The JAX package's state after ``x``: the sequential recurrence."""
    fn = JM._mlstm_state_from_full if key == MLSTM else JM._slstm_state_from_full
    return fn(jcfg, jp, jnp.asarray(x))


def _gathered(split, key, states):
    return gather_cache([{"blocks": {key: st}} for st in states], split)["blocks"][key]


# ---------------------------------------------------------------- the layers

# the mLSTM at S 300 runs two chunks, the second padded; the sLSTM has no
# chunked form, and S 19 covers its loop
FULL_CASES = [(MLSTM, 1), (MLSTM, 19), (MLSTM, 300), (SLSTM, 1), (SLSTM, 19)]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("key,S", FULL_CASES, ids=[f"{k[3:]}-S{S}" for k, S in FULL_CASES])
def test_xlstm_full_on_shards_matches_jax(key, S, d):
    """The full form on d shards: the partial outputs summed against the
    JAX layer, each shard's last state (on its heads) gathered against the
    JAX state."""
    jcfg, cfg, jparams, params = _model()
    split, scfg, mesh = _split(cfg, d)
    assert split.xlstm and scfg.n_heads == cfg.n_heads // d
    assert (scfg.mlstm_inner, scfg.slstm_inner) == (cfg.mlstm_inner // d, cfg.d_model // d)
    ps = shard_params(_layer(params["blocks"][key], 0), split, mesh)
    jp = _layer(jparams["blocks"][key], 0)["mixer"]
    x = _inputs((2, S, cfg.d_model), S)
    lanes = [M._period(M._state_leaves(scfg, key[3:], 2, "cpu"), 0) for _ in ps]
    full = M._TP_RECURRENT[key[3:]][0]
    outs = full(scfg, split, mesh, ps, mesh.broadcast(torch.tensor(x)), lanes)
    jfull = JL.mlstm_full if key == MLSTM else JL.slstm_full
    _close(mesh.reduce(outs)[0], jfull(jp, jnp.asarray(x), jcfg))
    assert lanes[0]["n"].shape[1] == cfg.n_heads // d       # each shard's heads
    state, want = _gathered(split, key, lanes), _jax_state(key, jcfg, jp, x)
    for name in STATE[key]:
        _close(state[name], want[name])


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("key", [MLSTM, SLSTM], ids=["mlstm", "slstm"])
def test_xlstm_step_on_shards_matches_jax(key, d):
    """One step on d shards from a state cut on its heads: the summed
    output and the gathered new state against the JAX step; the states
    passed in are not changed."""
    jcfg, cfg, jparams, params = _model()
    split, scfg, mesh = _split(cfg, d)
    ps = shard_params(_layer(params["blocks"][key], 0), split, mesh)
    jp = _layer(jparams["blocks"][key], 0)["mixer"]
    x = _inputs((3, 21, cfg.d_model), 5)
    jstate = _jax_state(key, jcfg, jp, x[:, :20])
    full = {"blocks": {key: {n: torch.tensor(np.asarray(v)) for n, v in jstate.items()}}}
    states = [s["blocks"][key] for s in shard_cache(full, split, mesh)]
    before = [{n: t.clone() for n, t in st.items()} for st in states]
    step = M._TP_RECURRENT[key[3:]][1]
    outs, news = step(scfg, split, mesh, ps, mesh.broadcast(torch.tensor(x[:, 20:21])), states)
    jstep = JL.mlstm_step if key == MLSTM else JL.slstm_step
    jout, jnew = jstep(jp, jnp.asarray(x[:, 20:21]), jcfg, jstate)
    _close(mesh.reduce(outs)[0], jout)
    new = _gathered(split, key, news)
    for name in STATE[key]:
        _close(new[name], jnew[name])
    assert all(torch.equal(a[n], b[n]) for a, b in zip(states, before) for n in a)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("d", [2, 4])
def test_forward_full_and_decode_on_mesh_match_jax(d):
    """A whole-prompt admission of two lanes on a mesh, then two decode
    steps (the second with a lane masked): logits and every state leaf,
    gathered, against the JAX forward and decode steps."""
    jcfg, cfg, jparams, params = _model()
    split, _, mesh = _split(cfg, d)
    ps = shard_params(params, split, mesh)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 20))
    logits, _, lanes = M.forward_full(cfg, ps, {"tokens": torch.tensor(tokens)}, capacity=32,
                                      mesh=mesh)
    jlogits, _, jcache = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                                         capacity=32)
    assert len(lanes) == d
    _close(logits, jlogits, LOGIT_TOL)
    active = [None, np.array([True, False])]
    for i, act in enumerate(active):
        tok = np.array([[7 + i], [11 + i]])
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok, jnp.int32),
                                         active=None if act is None else jnp.asarray(act))
        logits, lanes = M.decode_step(cfg, ps, lanes, torch.tensor(tok), mesh=mesh,
                                      active=None if act is None else torch.tensor(act))
        _close(logits, jlogits, LOGIT_TOL)
    lane = gather_cache(lanes, split)
    np.testing.assert_array_equal(lane["pos"].numpy(), np.asarray(jcache["pos"]))
    for key, c in jcache["blocks"].items():
        for name, want in c.items():
            _close(lane["blocks"][key][name], want)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunk_prefill_on_mesh_matches_jax(paged, d):
    """Chunks (padding rows included) prefilled on a mesh of d shards, each
    chunk's tokens stepped through the split mLSTM and sLSTM steps, into a
    dense lane or a paged lane's state row, then a decode step: the logits
    and the gathered lane or pool against the JAX ones."""
    jcfg, cfg, jparams, params = _model()
    split, _, mesh = _split(cfg, d)
    ps = shard_params(params, split, mesh)
    chunks = [(np.arange(8) + 3, 8), (np.array([40, 41, 42, 0, 0, 0, 0, 0]), 3)]
    if paged:
        row = np.asarray([2, 4, 0, 0], np.int32)
        jpool = JM.paged_set_lane(JM.init_paged_pool(jcfg, None, 2, 5, 8, 4), 1,
                                  jnp.asarray(row), 0)
        pools = shard_cache(M.paged_set_lane(M.init_paged_pool(cfg, 2, 5, 8, 4, "cpu"), 1,
                                             row, 0), split, mesh)
        for toks, n in chunks:
            jpool = JM.prefill_chunk_paged(jcfg, jparams, jpool, 1,
                                           jnp.asarray(toks[None], jnp.int32), n)
            M.prefill_chunk_paged(cfg, ps, pools, 1, torch.tensor(toks[None]), n, mesh=mesh)
        tok = np.array([[7], [11]])
    else:
        jpool = JM.init_cache(jcfg, None, 1, 16)
        pools = shard_cache(M.init_cache(cfg, 1, 16, "cpu"), split, mesh)
        for toks, n in chunks:
            jpool = JM.prefill_chunk(jcfg, jparams, jpool, jnp.asarray(toks[None], jnp.int32), n)
            M.prefill_chunk(cfg, ps, pools, torch.tensor(toks[None]), n, mesh=mesh)
        tok = np.array([[11]])
    jlogits, jpool = JM.decode_step(jcfg, jparams, jpool, jnp.asarray(tok, jnp.int32))
    logits, _ = M.decode_step(cfg, ps, pools, torch.tensor(tok), mesh=mesh)
    _close(logits, jlogits, LOGIT_TOL)
    pool = gather_cache(pools, split)
    np.testing.assert_array_equal(pool["pos"].numpy(), np.asarray(jpool["pos"]))
    for key, c in jpool["blocks"].items():
        for name, leaf in c.items():
            _close(pool["blocks"][key][name], np.asarray(leaf))


# ---------------------------------------------------------------- workers

CASES = [("paged", 2), ("paged", 4), ("dense", 2), ("dense", 4)]


@pytest.fixture(scope="module")
def refs():
    """plane -> (JAX script, JAX logits, port degree-1 script and logits),
    built once each."""
    cache = {}

    def get(plane):
        if plane not in cache:
            jcfg, cfg, jparams, params = _model()
            paged = plane == "paged"
            jw = JaxWorker(jcfg, jparams, sampler=JaxSampler(1.0), paged=paged, **KW)
            one = RolloutWorker(cfg, params, sampler=SamplerConfig(1.0), paged=paged,
                                device="cpu", **KW)
            jout, oout = _script(jw), _script(one)
            toks = _tokens(one)
            jlogits, _ = JM.decode_step(jcfg, jparams, jw.pool, jnp.asarray(toks))
            ologits, _ = M.decode_step(cfg, one.params, one.pool, torch.from_numpy(toks))
            cache[plane] = (jout, to_np(jlogits), oout, to_np(ologits))
        return cache[plane]

    return get


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-d{c[1]}")
def case(request, refs):
    plane, d = request.param
    _, cfg, _, params = _model()
    w = RolloutWorker(cfg, params, sampler=SamplerConfig(1.0), paged=plane == "paged",
                      mp=d, mesh=_mesh(d), **KW)
    out = _script(w)
    logits, _ = M.decode_step(cfg, w.params, w.pool, torch.from_numpy(_tokens(w)), mesh=w._tp)
    return (w, out, to_np(logits)) + refs(plane)


def test_sharded_xlstm_worker_matches_jax_worker(case):
    w, out, _, jout, _, oout, _ = case
    assert w._chunked                             # admitted by chunks on the mesh
    assert out == jout                            # tokens, block ids, counters
    assert out == oout
    stats = w.dispatch_stats()
    assert stats["mesh_devices"] == stats["mp"] == w.mp


def test_sharded_xlstm_logits_within_tolerance(case):
    w, _, logits, _, jlogits, _, ologits = case
    lanes = sorted(seq.slot for seq in w.store.values())
    assert np.abs(logits[lanes] - jlogits[lanes]).max() <= LOGIT_TOL
    assert np.abs(logits[lanes] - ologits[lanes]).max() <= LOGIT_TOL


def test_xlstm_shards_hold_their_heads(case):
    """Each shard holds 1/d of the xLSTM's weights and of every state
    leaf's heads; ``pos`` is the same on every shard."""
    w = case[0]
    d, cfg = w.mp, w.cfg
    H = cfg.n_heads // d
    assert len(w.params) == len(w.pool) == d
    for p, pool in zip(w.params, w.pool):
        m, s = p["blocks"][MLSTM]["mixer"], p["blocks"][SLSTM]["mixer"]
        assert m["l_up"].shape[-1] == m["l_q"].shape[-3] == cfg.mlstm_inner // d
        assert m["l_q"].shape[-2] == cfg.n_heads                  # partial products
        assert s["s_w"].shape[-2] == s["s_r"].shape[-3] == H
        assert s["s_out"].shape[-2] == cfg.d_model // d
        st = pool["blocks"]
        assert st[MLSTM]["C"].shape[-3] == st[MLSTM]["n"].shape[-2] == st[MLSTM]["m"].shape[-1] == H
        assert all(st[SLSTM][n].shape[-2] == H for n in STATE[SLSTM])
        assert torch.equal(pool["pos"], w.pool[0]["pos"])


@pytest.mark.parametrize("plane", ["paged", "dense"])
def test_xlstm_migration_crosses_degrees_bit_equal(plane):
    """A lane moves d2 -> d1 -> d4 -> d2: every package (the xLSTM state in
    the full-head layout on the host, and pos) and a checkpoint of the last
    are bit-equal to the first, and the lane decodes on as an unmigrated
    one."""
    _, cfg, _, params = _model()
    paged = plane == "paged"
    ref = _worker(cfg, params, 1, paged=paged)
    hops = [_worker(cfg, params, d, wid=i, paged=paged) for i, d in enumerate((2, 1, 4, 2))]
    for w in (ref, hops[0]):
        w.prefill(7, PROMPT)
    straight = ref.decode([7], 12)[7]
    first = hops[0].decode([7], 4)[7]
    pkg = hops[0].migrate_out(7)
    want = _payload(pkg)
    assert any(k.endswith(f"{MLSTM}/C") for k in want)
    assert any(k.endswith(f"{SLSTM}/h") for k in want)
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


def test_fleet_reconfigure_moves_an_xlstm_resident_across_degrees():
    """(2, 2) -> (4): the fleet carves a four-shard xLSTM worker and its
    resident moves from two shards to four, decoding on as an unmigrated
    lane."""
    _, cfg, _, params = _model()
    fleet = _fleet(cfg, params, (2, 2), 4)
    assert all(w.split.xlstm for w in fleet.workers)
    ref = RolloutWorker(cfg, params, capacity=32, max_slots=2, worker_id=1,
                        sampler=SamplerConfig(temperature=0.0), device="cpu")
    fleet.workers[1].prefill(5, PROMPT)
    ref.prefill(5, PROMPT)
    first = fleet.workers[1].decode([5], 6)[5]
    report = fleet.reconfigure(FleetSpec((4,)))
    assert report["to"] == [4] and report["migrated_residents"] == 1
    [w] = fleet.workers
    assert w.mp == 4 and w.mesh.degree == 4 and w.split.xlstm and 5 in w.store
    assert first + w.decode([5], 6)[5] == ref.decode([5], 12)[5]


def test_serve_cli_shards_xlstm_over_devices():
    out = _serve("--arch", "xlstm-350m", "--device", "cpu", "--devices", "cpu,cpu,cpu",
                 "--degrees", "2,1", "--requests", "8", "--steps", "2")
    assert out.returncode == 0, out.stderr
    assert "worker 0 (MP 2 over 2 devices)" in out.stdout and "worker 1 (MP 1)" in out.stdout
    assert "served 8 trajectories on cpu" in out.stdout
