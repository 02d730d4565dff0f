"""Tensor-parallel workers on distinct cards: the port on two or more cards.

Every test here is marked ``gpu`` and skips, inside the test, where fewer
than two CUDA devices are visible (four for the cuda:3 cases).  This file
imports no JAX.  On a machine with four cards:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_cards.py

A mesh of distinct cards runs the same additions on the same device, in
the same order, as a mesh whose shards share cuda:0 (``WorkerMesh.reduce``
sums on device 0): only the copies change, so everything here is held bit
for bit against the one-card placement.  The kernels are also held to their
plain versions run on the card they ran on, the holds computed on the host
(``torch.ldexp`` misbehaves on a card that is not the current device,
``tools/ldexp_cards.py``): 1e-5 in float32, 2.5e-2 in
bfloat16 (and 2e-2 of the output's size), the scan at 1e-4 of max(1, max
|plain|), its backward the same and half a bf16 ulp for the gradients it
returns in bf16, as ``tests/test_torch_gpu.py`` holds them on cuda:0.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from _torch_hold import hold_bf16_cast
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import shard_params, tp_split
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.kernels import decode_attention as kernel
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.kernels import ref
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.models import model as M

pytestmark = pytest.mark.gpu
TOL = {"float32": 1e-5, "bfloat16": 2.5e-2}
BF16_REL = 2e-2
SCAN_TOL = 1e-4
KW = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8,
          sampler=SamplerConfig(temperature=1.0, top_p=0.9))
PROMPT = [3 + i for i in range(20)]


def _need_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, {torch.cuda.device_count()} visible")


def _mesh(d, distinct):
    return WorkerMesh(tuple(torch.device("cuda", r if distinct else 0) for r in range(d)))


def _leaves(tree):
    return [(p, t) for p, t in M.tree_items(tree)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [2, 4])
def test_reduce_on_distinct_cards_bit_equal_to_one_card(d, dtype):
    _need_cards(d)
    gen = torch.Generator(device="cuda").manual_seed(d)
    parts = [torch.randn((8, 1, 2048), generator=gen, device="cuda").to(dtype)
             for _ in range(d)]
    one = _mesh(d, False).reduce(parts)
    cards = _mesh(d, True)
    got = cards.reduce([p.to(dev) for p, dev in zip(parts, cards.devices)])
    for r, (g, w) in enumerate(zip(got, one)):
        assert g.device == cards.devices[r] and g.dtype == dtype
        assert torch.equal(g.cpu(), w.cpu()), r
    assert all(cards.peer_access()[a, b] in (True, False) for a in range(d) for b in range(d)
               if a != b)


def _kernel_case(name, gen):
    """(wrapper, inputs on cuda:0, plain version) of one kernel at a shard's
    shape: the decode kernels at KV 4, G 2, lanes of up to 256; the scan and
    its backward at di 512, S 300 (a ragged last tile)."""
    if name in ("paged_decode_attention", "decode_attention"):
        B, KV, G, hd, ps, pages = 4, 4, 2, 128, 16, 16
        q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").bfloat16()
        vl = torch.randint(1, pages * ps + 1, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
        if name == "decode_attention":
            k, v = (torch.randn((B, pages * ps, KV, hd), generator=gen, device="cuda").bfloat16()
                    for _ in "kv")
            return kernel.decode_attention, [q, k, v, vl], ref.decode_attention_ref
        NB = B * pages + 1
        k, v = (torch.randn((NB, ps, KV, hd), generator=gen, device="cuda").bfloat16()
                for _ in "kv")
        pt = (torch.randperm(NB - 1, device="cuda", generator=gen)[:B * pages] + 1
              ).reshape(B, pages).int()
        return (kernel.paged_decode_attention, [q, k, v, pt, vl],
                ref.paged_decode_attention_ref)
    B, S, di, N = 1, 300, 512, 16
    dt = torch.nn.functional.softplus(torch.randn((B, S, di), generator=gen, device="cuda"))
    b_in, c_in = ((0.5 * torch.randn((B, S, N), generator=gen, device="cuda")).bfloat16()
                  for _ in "bc")
    x = (0.5 * torch.randn((B, S, di), generator=gen, device="cuda")).bfloat16()
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device="cuda")
                      ).expand(di, N).contiguous()
    args = [dt, b_in, c_in, x, a_log]
    if name == "mamba_scan":
        return scan_kernel.mamba_scan, args, ref.mamba_scan_ref
    g_y = torch.randn((B, S, di), generator=gen, device="cuda")
    g_h = torch.randn((B, di, N), generator=gen, device="cuda")
    return (scan_kernel.mamba_scan_bwd, [*args, g_y, g_h],
            lambda *a: ref.mamba_scan_bwd_ref(*(t.float() for t in a[:5]), *a[5:]))


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("card", [1, 3])
@pytest.mark.parametrize("name", ["paged_decode_attention", "decode_attention", "mamba_scan",
                                  "mamba_scan_bwd"])
def test_kernel_on_another_card_bit_equal_to_cuda0(name, card):
    """The wrapper called on inputs on ``cuda:card`` while cuda:0 is the
    current device: its output lies there, equals the cuda:0 launch's on the
    same inputs bit for bit and is within its limit of the plain version run
    there.  The limits are computed on the host: ``torch.ldexp`` on a card
    that is not the current device returns garbage (``tools/ldexp_cards.py``)."""
    _need_cards(card + 1)
    fn, args, plain = _kernel_case(name, torch.Generator(device="cuda").manual_seed(7))
    want0 = [t.cpu() for t in _outs(fn(*args))]
    dev = torch.device("cuda", card)
    there = [a.to(dev) for a in args]
    assert torch.cuda.current_device() == 0
    got = _outs(fn(*there))
    torch.cuda.synchronize(card)
    assert all(g.device == dev for g in got)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want0))
    for g, w in zip(got, _outs(plain(*there))):
        g, w = g.cpu(), w.cpu()
        if name.endswith("decode_attention"):
            limit = min(TOL["bfloat16"], BF16_REL * float(w.float().abs().max()))
            assert float((g.float() - w.float()).abs().max()) <= limit
        else:
            hold_bf16_cast(g, w, SCAN_TOL, name)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", ["qwen3_1_7b", "jamba_v0_1_52b"])
def test_sharded_init_on_cards_equals_one_card_cut(name, d):
    """``init_params(mesh=)`` over distinct cards: each shard on its card,
    bit-equal to the whole tree drawn on cuda:0 and cut for the mesh."""
    _need_cards(d)
    cfg = get_config(name).reduced(n_periods=1)
    mesh = _mesh(d, True)
    got = M.init_params(cfg, seed=3, mesh=mesh)
    want = shard_params(M.init_params(cfg, seed=3, device=torch.device("cuda", 0)),
                        tp_split(cfg, d), _mesh(d, False))
    assert got.split == want.split
    for r, (g, w) in enumerate(zip(got, want)):
        gl, wl = _leaves(g), _leaves(w)
        assert [p for p, _ in gl] == [p for p, _ in wl]
        for (path, a), (_, b) in zip(gl, wl):
            assert a.device == mesh.devices[r], path
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), path


def _script(w):
    w.prefill(1, PROMPT)
    w.prefill(2, PROMPT)
    w.prefill(3, [7, 11, 13, 5, 2, 9, 40, 41, 42, 43, 44])
    out = [w.decode([1, 2, 3], 6)]
    w.extend(1, [101, 102, 103])
    out.append(w.decode([1, 3], 4))
    return out


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", ["qwen3_1_7b", "jamba_v0_1_52b"])
def test_sharded_worker_on_cards_bit_equal_to_one_card(name, d):
    """A worker of degree d with one shard a card against the same worker
    with every shard on cuda:0 (f32, reduced, sampled at temperature 1):
    the same tokens and a teacher-forced step's logits bit for bit."""
    _need_cards(d)
    cfg = replace(get_config(name).reduced(n_periods=1), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cuda")
    runs = []
    for distinct in (False, True):
        w = RolloutWorker(cfg, params, mp=d, mesh=_mesh(d, distinct), device="cuda", **KW)
        out = _script(w)
        last = torch.tensor([[w.store[s].tokens[-1]] for s in (1, 2, 3)] + [[0]],
                            device="cuda")
        logits, _ = M.decode_step(cfg, w.params, w.pool, last, mesh=w._tp,
                                  active=torch.zeros(4, dtype=torch.bool, device="cuda"))
        runs.append((out, logits.cpu()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def test_migration_card_to_card_makes_no_host_copy():
    """A lane of a d2 worker on cuda:0-1 moved to a d1 worker on the last
    card: every package leaf on cuda:0, no device-to-host copy in the move
    (torch.profiler), and the lane decodes on there as an unmigrated lane."""
    from torch.profiler import ProfilerActivity, profile
    _need_cards(2)
    last = torch.cuda.device_count() - 1
    cfg = replace(get_config("qwen3_1_7b").reduced(n_periods=1), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cuda")
    ref_w = RolloutWorker(cfg, params, device="cuda", **KW)
    src = RolloutWorker(cfg, params, mp=2, mesh=_mesh(2, True), device="cuda", **KW)
    dst = RolloutWorker(cfg, params, worker_id=1, mesh=WorkerMesh((torch.device("cuda", last),)),
                        device="cuda", **KW)
    for w in (ref_w, src):
        w.prefill(5, PROMPT)
    straight = ref_w.decode([5], 10)[5]
    first = src.decode([5], 4)[5]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pkg = src.migrate_out(5)
        dst.migrate_in(pkg)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    leaves = list(M.tree_leaves({"pages": pkg["pages"], "state": pkg["state"]}))
    assert leaves and all(t.device == torch.device("cuda", 0) for t in leaves)
    assert not [e.name() for e in prof.profiler.kineto_results.events() if "DtoH" in e.name()]
    assert first + dst.decode([5], 6)[5] == straight
    np.testing.assert_array_equal(dst.store[5].key, ref_w.store[5].key)
