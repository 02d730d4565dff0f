"""The dry run on the H100 layout (``repro_torch.launch.dryrun``) against the
JAX package's step specs.

At the families' ``reduced()`` sizes, S 512 and B 2, degree 1, the port's
reckoned argument bytes equal the bytes of the JAX ``specs.build``
arguments, leaf for leaf in total, and its matrix-product FLOPs equal the
``dot_general`` FLOPs of the JAX step's jaxpr (scan bodies times their
length), exactly, less what the JAX step computes as plain products where
the port runs a hand-written kernel or nothing:

  * decode attention: the JAX step on the CPU runs the plain
    ``decode_attention_ref``, two products a layer; the port runs the dense
    kernel, whose operations its shape function reports by formula;
  * the selective scan: the JAX ``_mamba_scan_fused`` contracts each chunk's
    states with C as a product; the port runs the scan kernel;
  * the prefill's recurrent state: the JAX step runs a second pass
    (``_mamba_state_from_full``, ``_mlstm_state_from_full``,
    ``_slstm_state_from_full``) for the cache; the port's layers return the
    state of their one pass.

Each is traced alone through ``jax.make_jaxpr`` at the same shapes and
subtracted; the kernels' reported operations are held to their formulas
(``kernels/meta.py``).  ``dot_general``s with no contracted dimension (the
mLSTM's outer products) are left out: ``torch.einsum`` computes them as an
elementwise product.  Then the tensor-parallel records at degree 2 and 4,
the full-width records the JAX system test asks of its dry run, the kernels'
shape functions, and the memoized layer calls against running them.  The
JAX package's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import and is
not imported here.
"""

import math
import resource
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import combos as jax_combos
from repro.configs import get_config as jax_config
from repro.kernels import ref as jax_ref
from repro.launch import specs as JSP
from repro.models import config as JC
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import combos, get_config
from repro_torch.distributed.sharding import shard_cache, shard_params, tp_split
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.kernels import meta, ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import ProductionLayout, WorkerMesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import INPUT_SHAPES, InputShape

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = {"qwen3": "qwen3_1_7b", "jamba": "jamba_v0_1_52b", "qwen2_moe": "qwen2_moe_a2_7b",
            "arctic": "arctic_480b", "xlstm": "xlstm_350m", "whisper": "whisper_medium",
            "vlm": "llama_3_2_vision_11b"}
S, B = 512, 2
META = torch.device("meta")


def _layout(d: int, device=META) -> ProductionLayout:
    return ProductionLayout(1, WorkerMesh((torch.device(device),) * d))


def _reckon(cfg, mode, d=1, seq=S, batch=B):
    return D.reckon(cfg, InputShape(f"{mode}_{seq}", seq, batch, mode), _layout(d))


# ---------------------------------------------------------------- the JAX side

def _subjaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if hasattr(x, "eqns"):
                yield x
            elif hasattr(getattr(x, "jaxpr", None), "eqns"):
                yield x.jaxpr


def dot_flops(jaxpr) -> int:
    """2 x (output elements) x (contracted size) of every ``dot_general``
    with a contracted dimension, through sub-jaxprs, a scan's body times
    its length."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        assert name not in ("cond", "while"), name       # no data-dependent trip
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            if lc:
                k = math.prod(eqn.invars[0].aval.shape[i] for i in lc)
                total += 2 * k * math.prod(eqn.outvars[0].aval.shape)
        times = eqn.params["length"] if name == "scan" else 1
        total += times * sum(dot_flops(sub) for sub in _subjaxprs(eqn.params))
    return total


def traced_flops(fn, *args) -> int:
    return dot_flops(jax.make_jaxpr(fn)(*args).jaxpr)


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))


def jax_step(jcfg, mode):
    """(step function, argument specs) of the JAX ``specs.build`` at S, B,
    on a 1x1 mesh, traced without the mesh's context."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    fn, args, _ = JSP.build(jcfg, JC.InputShape(f"{mode}_{S}", S, B, mode), mesh)
    return fn, args


def spec_bytes(tree) -> int:
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in jax.tree.leaves(tree))


def _layer_counts(cfg):
    """(self-attention, cross-attention, Mamba, mLSTM, sLSTM) layers."""
    mixers = [k.partition("+")[0] for k in cfg.block_pattern]
    n = cfg.n_periods
    return (n * sum(m in ("attn", "dec") for m in mixers),
            n * sum(m in ("dec", "xattn") for m in mixers),
            n * mixers.count("mamba"), n * mixers.count("mlstm"), n * mixers.count("slstm"))


def _decode_ref_flops(jcfg, C) -> int:
    KV, hd, G = jcfg.n_kv_heads, jcfg.hd, jcfg.n_heads // jcfg.n_kv_heads
    dt = jcfg.dtype
    return traced_flops(jax_ref.decode_attention_ref, _sds((B, KV, G, hd), dt),
                        _sds((B, C, KV, hd), dt), _sds((B, C, KV, hd), dt),
                        _sds((B,), "int32"))


def _layer_params(jcfg, kind):
    """The JAX specs of one layer of ``kind``'s mixer params."""
    pspecs = JSP.param_specs(jcfg)
    i = jcfg.block_pattern.index(kind)
    return jax.tree.map(lambda x: _sds(x.shape[1:], x.dtype),
                        pspecs["blocks"][f"{i:02d}_{kind}"]["mixer"])


def _plain_flops(jcfg, mode) -> int:
    """The JAX step's products that the port runs as kernels or not at all
    (see the module docstring), each traced alone at the step's shapes."""
    n_self, n_cross, n_mamba, n_mlstm, n_slstm = _layer_counts(jcfg)
    dt, D_ = jcfg.dtype, jcfg.d_model
    if mode == "decode":
        T = jcfg.encoder_seq or jcfg.image_seq
        return (n_self * _decode_ref_flops(jcfg, S)
                + (n_cross * _decode_ref_flops(jcfg, T) if n_cross else 0))
    h = _sds((B, S, D_), dt)
    total = 0
    if n_mamba:
        kind = next(k for k in jcfg.block_pattern if k.startswith("mamba"))
        p = _layer_params(jcfg, kind)
        xc = _sds((B, S, jcfg.ssm_expand * D_), dt)
        scan = (traced_flops(lambda p, xc: JL._mamba_scan_fused(p, xc, jcfg), p, xc)
                - traced_flops(lambda p, xc: JL._mamba_inner(p, xc, jcfg), p, xc))
        state = traced_flops(lambda p, h: JM._mamba_state_from_full(jcfg, p, h), p, h)
        total += n_mamba * (scan + state)
    if n_mlstm:
        p = _layer_params(jcfg, "mlstm")
        total += n_mlstm * traced_flops(lambda p, h: JM._mlstm_state_from_full(jcfg, p, h),
                                        p, h)
    if n_slstm:
        p = _layer_params(jcfg, "slstm")
        total += n_slstm * traced_flops(lambda p, h: JM._slstm_state_from_full(jcfg, p, h),
                                        p, h)
    return total


def _kernel_formula(cfg, mode) -> tuple[int, dict]:
    """(operations, launches) of the kernels in the port's step by the
    formulas of ``kernels/meta.py``."""
    n_self, n_cross, n_mamba, _, _ = _layer_counts(cfg)
    item = M.torch_dtype(cfg).itemsize
    if mode == "decode":
        KV, hd, G = cfg.n_kv_heads, cfg.hd, cfg.n_heads // cfg.n_kv_heads
        T = cfg.encoder_seq or cfg.image_seq
        flops = (n_self * meta.decode_cost(B, KV, G, hd, B * S, item)[0]
                 + n_cross * meta.decode_cost(B, KV, G, hd, B * T, item)[0])
        return flops, ({"decode_attention": n_self + n_cross} if n_self + n_cross else {})
    if n_mamba:
        flops = meta.scan_cost(B, S, cfg.d_inner, cfg.ssm_state_dim, item)[0]
        return n_mamba * flops, {"mamba_scan": n_mamba}
    return 0, {}


# ---------------------------------------------------------------- the tests

def test_input_shapes_and_combos_are_the_reference_s():
    from repro_torch.models import config as TC
    assert {k: vars(v) for k, v in INPUT_SHAPES.items()} == \
        {k: vars(v) for k, v in JC.INPUT_SHAPES.items()}
    assert TC.LONG_CONTEXT_WINDOW == JC.LONG_CONTEXT_WINDOW
    mine = {(a, s): (None if c is None else (c.sliding_window, c.is_subquadratic()))
            for a, s, c in combos(include_skipped=True)}
    theirs = {(a, s): (None if c is None else (c.sliding_window, c.is_subquadratic()))
              for a, s, c in jax_combos(include_skipped=True)}
    assert mine == theirs and len(mine) == 40
    assert sum(c is None for c in mine.values()) == 1            # whisper long_500k
    assert len(list(combos())) == 39
    for a, s, c in combos():
        want = jax_config(a)
        if s == "long_500k" and not want.is_subquadratic():
            want = want.with_sliding_window(JC.LONG_CONTEXT_WINDOW)
        assert c.name == want.name and c.n_layers == want.n_layers


def test_production_layouts():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.name, one.chips, one.degree, one.replicas) == ("1x8", 8, 8, 1)
    assert (two.name, two.chips, two.degree, two.replicas) == ("2x1x8", 16, 8, 2)
    assert all(d.type == "meta" for d in one.mesh.devices + two.mesh.devices)
    assert two.batch(128, 2) == 64 and two.batch(1, 2) == 1 and one.batch(32, 1) == 32
    assert make_production_mesh(device="cpu").mesh.devices[0].type == "cpu"


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_degree_1_bytes_and_products_against_jax(family, mode):
    arch = FAMILIES[family]
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    fn, args = jax_step(jcfg, mode)
    rec, _ = _reckon(cfg, mode)
    assert rec["argument_size_in_bytes"] == spec_bytes(args)
    jax_flops = dot_flops(jax.make_jaxpr(fn)(*args).jaxpr)
    assert rec["product_flops"] == jax_flops - _plain_flops(jcfg, mode)
    flops, launches = _kernel_formula(cfg, mode)
    assert rec["kernel_flops"] == flops and rec["kernel_launches"] == launches
    assert rec["hlo_flops"] == rec["product_flops"] + rec["kernel_flops"]
    assert rec["collective_total_bytes"] == 0 and rec["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("family", ["qwen3", "jamba", "whisper"])
def test_train_argument_bytes_against_jax(family):
    """Params, AdamW moments (bf16 for a bf16 config) and the batch."""
    arch = FAMILIES[family]
    for dtype in ("float32", "bfloat16"):
        jcfg = jax_config(arch).reduced(dtype=dtype)
        cfg = get_config(arch).reduced(dtype=dtype)
        _, (pspecs, ospecs, bspecs) = jax_step(jcfg, "train")
        step = SP.build(cfg, InputShape("t", S, B, "train"), _layout(1))
        params, state, batch = step.args
        assert sum(t.nbytes for t in M.tree_leaves(params)) == spec_bytes(pspecs)
        assert (state.step.nbytes + sum(t.nbytes for t in M.tree_leaves(state.mu))
                + sum(t.nbytes for t in M.tree_leaves(state.nu))) == spec_bytes(ospecs)
        assert {k: t.nbytes for k, t in batch.items()} == \
            {k: spec_bytes(v) for k, v in bspecs.items()}
        rec, _ = _reckon(cfg, "train")              # the step itself, on meta
        assert rec["argument_size_in_bytes"] == spec_bytes((pspecs, ospecs, bspecs))
        assert rec["output_size_in_bytes"] >= spec_bytes((pspecs, ospecs))
        assert rec["product_flops"] > 0 and rec["temp_size_in_bytes"] > 0


def _cpu_shard_bytes(cfg, mode, d):
    """Each shard's bytes of ``shard_params`` and ``shard_cache`` of a tree
    made on the CPU (a leaf shared between shards counts on each), the
    step's inputs on shard 0."""
    mesh = WorkerMesh((torch.device("cpu"),) * d)
    split = tp_split(cfg, d)
    trees = [[t] for t in shard_params(M.init_params(cfg, 0, "cpu"), split, mesh)]
    if mode == "decode":
        cache = M.init_cache(cfg, B, S, "cpu", start_pos=S - 1, enc_len=SP.cross_len(cfg))
        for r, c in enumerate(shard_cache(cache, split, mesh)):
            trees[r].append(c)
        trees[0].append(torch.zeros((B, 1), dtype=torch.int32))
    else:
        trees[0].append(SP.batch_tensors(cfg, B, S, mode, "cpu"))
    return [sum(t.nbytes for t in D._tensors(tr)) for tr in trees]


def _reduces(cfg, split, mode) -> int:
    """All-reduces of one step on a mesh: the embedding's when the
    vocabulary is cut; a layer's attention output, both of a ``dec`` layer's
    attentions, Mamba's projection and output, the mLSTM's five q/k/v/gate
    products and its output, the sLSTM's output, each when its group is cut;
    the MLP's or MoE's output when cut; the audio encoder's attention and
    MLP in a prefill."""
    n = int(split.vocab)
    per = {"attn": split.attn, "xattn": split.attn, "dec": 2 * split.attn,
           "mamba": 2 * split.ssm, "mlstm": 6 * split.xlstm, "slstm": int(split.xlstm)}
    for kind in cfg.block_pattern:
        mixer, _, mlp = kind.partition("+")
        n += cfg.n_periods * (per[mixer] + (split.mlp if mlp == "mlp" else
                                            split.any_moe() if mlp else 0))
    if cfg.arch_type == "audio" and mode == "prefill":
        n += cfg.encoder_layers * (split.attn + split.mlp)
    return n


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tensor_parallel_records(family, mode, d):
    cfg = get_config(FAMILIES[family]).reduced()
    split = tp_split(cfg, d)
    base, _ = _reckon(cfg, mode)
    rec, tally = _reckon(cfg, mode, d)
    cards = [tally.per_card(r) for r in range(d)]
    assert [c["argument_size_in_bytes"] for c in cards] == _cpu_shard_bytes(cfg, mode, d)
    assert rec["collective_counts"]["all-reduce"] == _reduces(cfg, split, mode)
    assert rec["collective_counts"]["all-gather"] == int(split.vocab)
    assert all(c["hlo_flops"] <= base["hlo_flops"] for c in cards)
    assert all(c["temp_size_in_bytes"] > 0 for c in cards)
    # each card launches its share of the kernels: one a layer
    assert all(c["kernel_launches"] == base["kernel_launches"] for c in cards)
    wire = rec["collective_bytes"]
    assert rec["collective_total_bytes"] == wire["all-reduce"] + wire["all-gather"] > 0


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-1.7b"])
def test_run_one_at_full_width(arch):
    """The JAX system test's contract (tests/test_system.py), in process:
    nothing is allocated at full width."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.time()
    rec = D.run_one(arch, "decode_32k", verbose=False)
    assert time.time() - t0 < 60
    assert rec["status"] == "ok" and rec["chips"] == 8 and rec["mesh"] == "1x8"
    assert rec["hlo_flops"] > 0 and rec["collective_total_bytes"] >= 0
    assert (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss) * 1024 < 2**30
    assert rec["argument_size_in_bytes"] > 2**30                 # the 32k-slot KV cache
    cfg = get_config(arch)
    assert rec["kernel_launches"] == {"decode_attention": cfg.n_layers}
    two = D.run_one(arch, "decode_32k", multi_pod=True, verbose=False)
    assert (two["mesh"], two["chips"], two["batch"]) == ("2x1x8", 16, 64)


def test_run_one_skips_whisper_long_context():
    rec = D.run_one("whisper-medium", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "bounded" in rec["reason"]
    window = D.run_one("qwen3-1.7b", "long_500k", verbose=False)
    assert window["capacity"] == JC.LONG_CONTEXT_WINDOW and window["batch"] == 1


def test_main_prints_the_summary(capsys, tmp_path):
    out = tmp_path / "d.json"
    assert D.main(["--arch", "smollm-135m", "--shape", "long_500k", "--both-meshes",
                   "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "dry-run [1x8]: 1 ok, 0 skipped, 0 failed / 1 total" in text
    assert "dry-run [2x1x8]: 1 ok, 0 skipped, 0 failed / 1 total" in text
    assert "dry-run: 2 ok, 0 skipped, 0 failed / 2 total" in text
    assert out.exists()


# ---------------------------------------------------------------- shape functions

def _decode_inputs(dev, dtype=torch.float32, paged=False):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 2, 64, generator=g, dtype=dtype)
    if paged:
        kv = torch.randn(5, 16, 2, 64, generator=g, dtype=dtype)
        pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        args = (q, kv, kv.clone(), pt, torch.tensor([20, 32], dtype=torch.int32))
    else:
        kv = torch.randn(2, 40, 2, 64, generator=g, dtype=dtype)
        args = (q, kv, kv.clone(), torch.tensor([7, 40], dtype=torch.int32))
    return tuple(a.to(dev) for a in args)


class _Reports:
    def __init__(self):
        self.calls = []

    def kernel(self, name, flops, nbytes, like):
        self.calls.append((name, flops, nbytes, like.device.type))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shape_functions_match_the_plain_versions(dtype):
    before = {**decode_kernel.launches, **scan_kernel.launches}
    reports = _Reports()
    meta.open_tally(reports)
    try:
        for paged in (False, True):
            fn = decode_kernel.paged_decode_attention if paged else decode_kernel.decode_attention
            want = fn(*_decode_inputs("cpu", dtype, paged))
            got = fn(*_decode_inputs("meta", dtype, paged))
            assert (got.shape, got.dtype, got.device.type) == (want.shape, want.dtype, "meta")
        g = torch.Generator().manual_seed(1)
        cpu = [torch.rand(1, 9, 8, generator=g), torch.randn(1, 9, 4, generator=g).to(dtype),
               torch.randn(1, 9, 4, generator=g).to(dtype),
               torch.randn(1, 9, 8, generator=g).to(dtype), torch.randn(8, 4, generator=g)]
        for fn, extra in ((scan_kernel.mamba_scan, ()),
                          (scan_kernel.mamba_scan_bwd, (torch.randn(1, 9, 8), None))):
            want = fn(*cpu, *extra)
            got = fn(*(t.to("meta") for t in cpu), *(None if t is None else t.to("meta")
                                                     for t in extra))
            assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
            assert all(t.device.type == "meta" for t in got)
    finally:
        meta.close_tally(reports)
    assert {**decode_kernel.launches, **scan_kernel.launches} == before
    item = torch.empty((), dtype=dtype).element_size()
    assert reports.calls == [
        ("decode_attention", *meta.decode_cost(2, 2, 2, 64, 2 * 40, item), "meta"),
        ("paged_decode_attention", *meta.decode_cost(2, 2, 2, 64, 2 * 32, item, 4), "meta"),
        ("mamba_scan", *meta.scan_cost(1, 9, 8, 4, item), "meta"),
        ("mamba_scan_bwd", *meta.scan_bwd_cost(1, 9, 8, 4, item), "meta")]


def test_the_device_rule_is_a_function_of_the_device():
    assert meta.arm("k", torch.device("cpu")) == "plain"
    assert meta.arm("k", torch.device("meta")) == "meta"
    assert meta.arm("k", torch.device("cuda", 1)) == "kernel"
    for name in ("decode_attention", "mamba_scan"):
        with pytest.raises(ValueError, match=f"{name}: no kernel for device xpu"):
            meta.arm(name, torch.device("xpu"))


def test_shape_functions_refuse_what_the_kernels_refuse():
    q, k, v, vl = _decode_inputs("meta")
    with pytest.raises(ValueError, match="not built"):
        decode_kernel.decode_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                       v[..., :48].contiguous(), vl)
    with pytest.raises(TypeError, match="differ in dtype"):
        decode_kernel.decode_attention(q, k.bfloat16(), v, vl)
    dt = torch.empty(1, 9, 8, device="meta")
    bc = torch.empty(1, 9, 5, device="meta")
    with pytest.raises(ValueError, match="not built"):
        scan_kernel.mamba_scan(dt, bc, bc, dt, torch.empty(8, 5, device="meta"))


def test_scan_autograd_on_meta_reports_both_kernels():
    reports = _Reports()
    dt = torch.empty(1, 9, 8, device="meta", requires_grad=True)
    x = torch.empty(1, 9, 8, device="meta", requires_grad=True)
    bc = torch.empty(1, 9, 4, device="meta")
    meta.open_tally(reports)
    try:
        y, _ = ops.mamba_scan(dt, bc, bc, x, torch.empty(8, 4, device="meta"))
        grads = torch.autograd.grad(y.sum(), [dt, x])
    finally:
        meta.close_tally(reports)
    assert [g.shape for g in grads] == [dt.shape, x.shape]
    assert [c[0] for c in reports.calls] == ["mamba_scan", "mamba_scan_bwd"]


# ---------------------------------------------------------------- memoized layer calls

@pytest.mark.parametrize("family,mode,d", [("qwen3", "prefill", 1), ("qwen3", "decode", 2),
                                           ("jamba", "prefill", 2), ("xlstm", "prefill", 4),
                                           ("whisper", "prefill", 2), ("vlm", "decode", 4),
                                           ("qwen2_moe", "prefill", 4), ("jamba", "train", 1),
                                           ("xlstm", "train", 1)])
def test_memoized_calls_count_what_running_them_counts(family, mode, d, monkeypatch):
    """Every field of every card, with the layer functions and the ops'
    output shapes memoized and with every call and every op run (at two
    periods, so that calls repeat across periods as well as shards)."""
    cfg = get_config(FAMILIES[family]).reduced(n_periods=2)
    memo, tally = _reckon(cfg, mode, d, seq=64)
    assert (tally.memo_hits > 0) == (mode != "train") and tally._op_memo   # grads always run
    monkeypatch.setattr(D, "MEMOIZED", ())
    monkeypatch.setattr(D.Tally, "_run", lambda self, func, args, kwargs: func(*args, **kwargs))
    full, plain = _reckon(cfg, mode, d, seq=64)
    assert plain.memo_hits == 0
    assert memo == full
    assert [tally.per_card(r) for r in range(d)] == [plain.per_card(r) for r in range(d)]


def test_memoized_functions_are_restored():
    from repro_torch.models import layers
    fn = layers.attention_full
    _reckon(get_config("qwen3_1_7b").reduced(), "prefill", 2, seq=32)
    assert layers.attention_full is fn


def test_the_step_built_on_the_cpu_runs():
    """``specs.build`` on a CPU layout makes real arguments: the step runs
    its plain versions, and its argument bytes are the meta step's."""
    cfg = replace(get_config("qwen3_1_7b").reduced(), dtype="bfloat16")
    step = SP.build(cfg, InputShape("d", 64, B, "decode"), _layout(1, "cpu"))
    rec, _ = _reckon(cfg, "decode", seq=64)
    assert rec["argument_size_in_bytes"] == sum(t.nbytes for t in D._tensors(step.args))
    logits, _ = step.fn(*step.args)
    assert logits.shape == (B, cfg.vocab) and torch.isfinite(logits).all()
