"""Weights made already cut for a mesh, and migration packages that stay on
the source's device 0: the CPU side of tensor-parallel workers on distinct
cards.

  * ``init_params(cfg, seed, mesh=)`` draws each leaf in ``init_params``'
    order on the mesh's device 0, cuts it and drops it: bit-equal to
    ``shard_params(init_params(...), tp_split(cfg, d), mesh)`` on reduced
    qwen3, jamba and xLSTM at ``[cpu] * 2`` and ``[cpu] * 4``;
  * a worker given such weights (``ShardedParams``, here cut from the JAX
    package's params through ``repro_torch.params.from_jax``) keeps them as
    they are and emits the JAX worker's tokens, block ids and counters on
    reduced qwen3 and jamba at degree 2 (``tests/test_torch_tp.py``'s
    script, sampled at temperature 1 / top-p 0.9);
  * weights cut for another degree or split, with a leaf of another shape
    or name, or on another device, are refused;
  * a sharded worker's migration package lies on its device 0, not on the
    host: a worker on a mesh of two ``meta`` devices takes a lane in and
    gives it back with every leaf on ``meta`` (a copy to the host would
    raise there), and a ``[cpu] * 2`` worker's package is bit-equal to the
    one it took in.
"""

from dataclasses import replace

import pytest
import torch

from repro.engine.sampler import SamplerConfig as JaxSampler
from repro.engine.worker import RolloutWorker as JaxWorker
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardedParams, TPSplit, shard_params, tp_split
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.models import model as M

from _torch_parity import jax_and_port, one_torch_thread  # noqa: F401
from test_torch_tp import KW, PROMPT, _payload, _script

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")


def _mesh(d, dev=CPU):
    return WorkerMesh((dev,) * d)


def _same_trees(a, b):
    la, lb = list(M.tree_items(a)), list(M.tree_items(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), path


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", ["qwen3_1_7b", "jamba_v0_1_52b", "xlstm_350m"])
def test_sharded_init_equals_cut_of_whole_init(name, d):
    cfg = get_config(name).reduced(n_periods=1)
    mesh = _mesh(d)
    got = M.init_params(cfg, seed=11, mesh=mesh)
    want = shard_params(M.init_params(cfg, seed=11, device="cpu"), tp_split(cfg, d), mesh)
    assert isinstance(got, ShardedParams) and got.split == want.split == tp_split(cfg, d)
    assert len(got) == d
    for g, w in zip(got, want):
        _same_trees(g, w)


def test_sharded_init_draws_leaf_by_leaf(monkeypatch):
    """Each drawn leaf is cut into its d pieces before the next is drawn:
    the whole tree never exists on the mesh's device 0."""
    from repro_torch.distributed import sharding
    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    events = []
    randn, piece = torch.randn, sharding._piece
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **kw: (events.append("draw"), randn(*a, **kw))[1])
    monkeypatch.setattr(sharding, "_piece",
                        lambda *a, **kw: (events.append("cut"), piece(*a, **kw))[1])
    M.init_params(cfg, seed=0, mesh=_mesh(2))
    draws = [i for i, e in enumerate(events) if e == "draw"]
    assert len(draws) > 10
    assert all(events[i + 1:i + 3] == ["cut", "cut"] for i in draws)


@pytest.mark.parametrize("model", ["qwen3", "jamba"])
def test_worker_on_presharded_params_matches_jax_worker(model):
    name = {"qwen3": "qwen3_1_7b", "jamba": "jamba_v0_1_52b"}[model]
    n = 2 if model == "qwen3" else 1
    jcfg, cfg, jparams, params = jax_and_port(name, n_periods=n)
    want = _script(JaxWorker(jcfg, jparams, sampler=JaxSampler(1.0), paged=True, **KW))
    shards = shard_params(params, tp_split(cfg, 2), _mesh(2))
    w = RolloutWorker(cfg, shards, sampler=SamplerConfig(1.0), paged=True, mp=2,
                      mesh=_mesh(2), **KW)
    assert w.params is shards
    assert _script(w) == want


def _refused(cfg, shards, mesh, match):
    with pytest.raises(ValueError, match=match):
        RolloutWorker(cfg, shards, mp=mesh.degree, mesh=mesh, **KW)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3_1_7b").reduced(n_periods=1)
    return cfg, M.init_params(cfg, seed=0, device="cpu")


def test_presharded_params_of_another_degree_or_split_are_refused(qwen):
    cfg, params = qwen
    _refused(cfg, shard_params(params, tp_split(cfg, 2), _mesh(2)), _mesh(4), "2 shards")
    other = TPSplit(2, attn=False, mlp=True, vocab=True)
    _refused(cfg, shard_params(params, other, _mesh(2)), _mesh(2), "split|attn=False")
    one = RolloutWorker(cfg, shard_params(params, tp_split(cfg, 1), _mesh(1)), mesh=_mesh(1),
                        **KW)
    _same_trees(one.params, params)


@pytest.mark.parametrize("fault", ["shape", "name", "device"])
def test_presharded_params_that_do_not_fit_are_refused(qwen, fault):
    cfg, params = qwen
    shards = shard_params(params, tp_split(cfg, 2), _mesh(2))
    mixer = shards[1]["blocks"]["00_attn+mlp"]["mixer"]
    if fault == "shape":
        mixer["wq"] = mixer["wq"][..., :-1]
        match = "wq has shape"
    elif fault == "name":
        mixer["wx"] = mixer.pop("wq")
        match = "leaves"
    else:
        mixer["wq"] = mixer["wq"].to("meta")
        match = "is on meta"
    _refused(cfg, shards, _mesh(2), match)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_migration_package_stays_on_the_workers_device_0(qwen, paged):
    cfg, params = qwen
    cfg = replace(cfg, dtype="float32")
    src = RolloutWorker(cfg, params, mp=2, mesh=_mesh(2), paged=paged, **KW)
    src.prefill(5, PROMPT)
    src.decode([5], 4)
    pkg = src.migrate_out(5)
    want = _payload(pkg)
    meta = torch.device("meta")
    w = RolloutWorker(cfg, params, mp=2, mesh=_mesh(2, meta), paged=paged, **KW)
    w.migrate_in(pkg)
    assert {t.device for pool in w.pool for t in M.tree_leaves(pool)} == {meta}
    out = w.migrate_out(5)
    got = _payload(out)
    assert got.keys() == want.keys()
    assert all(t.device == meta and t.shape == want[k].shape for k, t in got.items())
    back = RolloutWorker(cfg, params, mp=2, mesh=_mesh(2), paged=paged, **KW)
    back.migrate_in(pkg)
    again = _payload(back.migrate_out(5))
    assert all(torch.equal(again[k], t) for k, t in want.items())
    assert out["logical_bytes"] == pkg["logical_bytes"]
