"""The audio encoder-decoder (whisper-medium) and the gated VLM
cross-attention (llama-3.2-vision-11b) against the JAX package.

Configs at ``reduced()`` size (d 256, 4 heads of 64, 2 encoder layers, 32
frames or patches; whisper 2 periods of ``dec+mlp``, the VLM 1 period of 4
``attn+mlp`` and 1 ``xattn+mlp``) and a VLM case at ``n_kv_heads=2``, whose
cross-attention decodes at G 2 as the full model's does at G 4 (the reduced
VLM has 4/4 heads).  Params come from the JAX ``init_params``, carried across
by ``from_jax``, with every ``xgate`` set to 0.7 in numpy first: the gate
starts at 0 and ``tanh(0) = 0`` would hide the cross path.  Inputs are drawn
with numpy from a seed; the embeddings are in the config's dtype in both
packages (the port does not promote).

Tolerances: float32 logits 1e-4 and cache leaves and encoder outputs 2e-5
absolute (sums in another order); bfloat16 2% of the reference's largest
|value| (one or two bf16 ulps of it: both packages round q, k, v and the
products to bf16 after sums in another order).  Cross-attention decode is
held to the Pallas kernel in interpret mode at 1e-5 in f32.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.engine.worker import RolloutWorker as JaxWorker
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.engine.worker import RolloutWorker
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ["whisper_medium", "llama_3_2_vision_11b"]
# (config, overrides): the VLM at n_kv_heads 2 runs its cross-attention at G 2
CASES = [("whisper_medium", {}), ("llama_3_2_vision_11b", {}),
         ("llama_3_2_vision_11b", {"n_kv_heads": 2})]
CASE_IDS = ["whisper", "vlm", "vlm-G2"]
XGATE = 0.7
LOGIT_TOL, LEAF_TOL = 1e-4, 2e-5
BF16_REL = 2e-2
KEY = jax.random.PRNGKey(0)


def _configs(name, **kw):
    """(JAX config, port config), reduced as the reference's model tests do."""
    periods = 2 if len(jax_config(name).block_pattern) == 1 else 1
    jcfg = jax_config(name).reduced(n_periods=periods, **kw)
    cfg = get_config(name).reduced(n_periods=periods, **kw)
    assert all(getattr(jcfg, k) == v for k, v in vars(cfg).items()), name
    return jcfg, cfg


def _open_gates(tree):
    """Every ``xgate`` leaf of a numpy pytree set to XGATE, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _open_gates(v)
        elif k == "xgate":
            tree[k] = np.full_like(v, XGATE)
    return tree


_MODELS = {}


def _models(name, dtype="float32", **kw):
    """(jcfg, cfg, JAX params, port params), the same numbers in both."""
    key = (name, dtype, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg, cfg = _configs(name, dtype=dtype, **kw)
        tree = _open_gates(jax.tree.map(np.asarray, JM.init_params(jcfg, KEY)))
        _MODELS[key] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                        from_jax(tree, device="cpu"))
    return _MODELS[key]


def _batch(cfg, tokens, seed=11):
    """Both packages' batches: ``tokens`` and the config's embeddings (B, T,
    d) drawn from ``seed``, in the config's dtype."""
    B = tokens.shape[0]
    name, T = (("encoder_embeds", cfg.encoder_seq) if cfg.arch_type == "audio"
               else ("image_embeds", cfg.image_seq))
    emb = np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32), name: jnp.asarray(emb).astype(cfg.dtype)}
    tb = {"tokens": torch.tensor(tokens), name: torch.tensor(emb).to(M.torch_dtype(cfg))}
    return jb, tb


def _close(got, want, dtype, tol, label=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    limit = tol if dtype == "float32" else BF16_REL * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=limit, rtol=0, err_msg=label)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------- configs and init


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_jax_and_reduce_the_encoder(name):
    """Every field of the port's config equals the JAX one, at full size and
    reduced; ``reduced()`` cuts the encoder to 2 layers and 32 frames or
    patches, as the reference does."""
    full = get_config(name)
    assert all(getattr(jax_config(name), k) == v for k, v in vars(full).items())
    cfg = full.reduced()
    assert all(getattr(jax_config(name).reduced(), k) == v for k, v in vars(cfg).items())
    if full.arch_type == "audio":
        assert (full.encoder_layers, full.encoder_seq) == (24, 1500)
        assert (cfg.encoder_layers, cfg.encoder_seq, cfg.image_seq) == (2, 32, 0)
    else:
        assert full.image_seq == 1600
        assert (cfg.encoder_layers, cfg.encoder_seq, cfg.image_seq) == (0, 0, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_init_params_leaves_match_jax(name, dtype):
    """Leaf names, shapes and dtypes of ``init_params`` against
    ``jax.eval_shape`` of the reference's: ``xgate`` a 0-d leaf per period
    initialised to 0, no qk-norm on cross layers, LayerNorm biases on every
    norm (``norm_x``, the encoder's, ``enc_norm``), ``enc_blocks`` stacked
    over the encoder layers, ``enc_proj``."""
    jcfg, cfg = _configs(name, dtype=dtype)
    want = dict(_leaves(jax.eval_shape(lambda: JM.init_params(jcfg, KEY))))
    params = M.init_params(cfg, seed=0, device="cpu")
    got = dict(_leaves(params))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == str(want[path].dtype), path
    gates = [leaf for path, leaf in got.items() if path.endswith("xgate")]
    assert gates and all(g.shape == (cfg.n_periods,) and not g.any() for g in gates)
    if cfg.arch_type == "audio":
        assert "blocks/00_dec+mlp/norm_x/bias" in got and "enc_norm/bias" in got
        assert got["enc_blocks/00_enc_attn+mlp/mixer/wq"].shape[0] == cfg.encoder_layers
    else:
        assert got["enc_proj"].shape == (cfg.d_model, cfg.d_model)


# ---------------------------------------------------------------- encoder and model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    """The audio encoder (sinusoidal positions, non-causal self-attention
    without RoPE, MLP, ``enc_norm``) on the same frame embeddings."""
    jcfg, cfg, jparams, params = _models("whisper_medium", dtype)
    jb, tb = _batch(cfg, np.zeros((2, 1), np.int64))
    want = JM._encoder(jcfg, jparams, jb["encoder_embeds"])
    got = M._encoder(cfg, params, tb["encoder_embeds"])
    assert got.dtype == M.torch_dtype(cfg) and tuple(got.shape) == want.shape
    _close(got, want, dtype, LEAF_TOL, "encoder")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(("name", "kw"), CASES, ids=CASE_IDS)
def test_forward_and_decode_match_jax(name, kw, dtype):
    """``forward_full`` logits; ``forward_full(capacity)``'s logits and cache
    (``pos``, ``k``, ``v``, ``xk``, ``xv``); then three decode steps (two
    lanes, teacher-forced with the JAX argmax): logits and every cache leaf
    after them."""
    jcfg, cfg, jparams, params = _models(name, dtype, **kw)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 11))
    jb, tb = _batch(cfg, toks)
    jlogits, _ = JM.forward_full(jcfg, jparams, jb)
    logits, aux = M.forward_full(cfg, params, tb)
    _close(logits, jlogits, dtype, LOGIT_TOL, "forward logits")
    assert float(aux) == 0.0

    jl, _, jcache = JM.forward_full(jcfg, jparams, jb, capacity=16)
    lg, _, cache = M.forward_full(cfg, params, tb, capacity=16)
    _close(lg, jl, dtype, LOGIT_TOL, "forward(capacity) logits")

    def check_cache(when):
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
        assert cache["blocks"].keys() == jcache["blocks"].keys()
        for key, c in jcache["blocks"].items():
            assert cache["blocks"][key].keys() == c.keys(), key
            for leaf, want in c.items():
                _close(cache["blocks"][key][leaf], want, dtype, LEAF_TOL,
                       f"{name} {when} {key}/{leaf}")

    check_cache("after admission")
    tok = np.asarray([[1], [2]], np.int32)
    for step in range(3):
        jl, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok))
        lg, cache = M.decode_step(cfg, params, cache, torch.tensor(tok))
        _close(lg, jl, dtype, LOGIT_TOL, f"decode step {step}")
        tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    check_cache("after 3 decode steps")


@pytest.mark.parametrize(("name", "kw"), CASES, ids=CASE_IDS)
def test_decode_equals_full_forward(name, kw):
    """The reference's serving property (``tests/test_models.py``) on the
    port alone: a cache admitted from 12 tokens, then 3 decode steps, give
    the logits of one full forward over all 15 (f32, the reference's 2e-3)."""
    _, cfg, _, params = _models(name, **kw)
    S, extra = 12, 3
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, S + extra))
    _, full = _batch(cfg, toks)
    full_logits, _ = M.forward_full(cfg, params, full)
    lg, _, cache = M.forward_full(cfg, params, dict(full, tokens=full["tokens"][:, :S]),
                                  capacity=S + extra + 1)
    errs = [float((lg[:, -1] - full_logits[:, S - 1]).abs().max())]
    for t in range(extra):
        dl, cache = M.decode_step(cfg, params, cache, full["tokens"][:, S + t][:, None])
        errs.append(float((dl - full_logits[:, S + t]).abs().max()))
    assert max(errs) < 2e-3, errs


@pytest.mark.parametrize(("name", "kw", "T"), [("whisper_medium", {}, 600),
                                                ("llama_3_2_vision_11b", {"n_kv_heads": 2},
                                                 700)], ids=["G1-T600", "G2-T700"])
def test_cross_attention_decode_matches_pallas(name, kw, T):
    """``cross_attention_decode`` against the JAX one through the Pallas
    kernel in interpret mode (``use_pallas_decode``), at a T that is not a
    multiple of the kernel's 512-token tile, on a layer's own weights."""
    jcfg, cfg, jparams, params = _models(name, **kw)
    key = next(k for k in params["blocks"] if k.partition("_")[2].startswith(("dec", "xattn")))
    part = "xattn" if "dec" in key else "mixer"
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"][key][part])
    p = {n: t[0] for n, t in params["blocks"][key][part].items()}
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((3, T, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
              for _ in "kv")
    want = JL.cross_attention_decode(jp, jnp.asarray(x), replace(jcfg, use_pallas_decode=True),
                                     jnp.asarray(ck), jnp.asarray(cv))
    got = L.cross_attention_decode(p, torch.tensor(x), cfg, torch.tensor(ck), torch.tensor(cv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("name", NAMES)
def test_embeddings_of_another_dtype_raise(name):
    """The port takes embeddings in the model's dtype and promotes nothing."""
    _, cfg, _, params = _models(name)
    _, tb = _batch(cfg, np.zeros((1, 4), np.int64))
    emb = next(k for k in tb if k.endswith("_embeds"))
    for dtype in (torch.bfloat16, torch.float64):
        with pytest.raises(TypeError, match=emb):
            M.forward_full(cfg, params, dict(tb, **{emb: tb[emb].to(dtype)}))
    with pytest.raises(KeyError):
        M.forward_full(cfg, params, {"tokens": tb["tokens"]})


@pytest.mark.parametrize("name", NAMES)
def test_cross_caches_need_the_encoder_length_and_stay_dense(name):
    """A cross-attention cache is sized by the embeddings' length; without
    it ``init_cache`` raises, and there is no paged pool for these configs."""
    _, cfg = _configs(name)
    assert not M.supports_paged_kv(cfg) and not M.supports_chunked_prefill(cfg)
    with pytest.raises(ValueError, match="enc_len"):
        M.init_cache(cfg, 2, 8, "cpu")
    cache = M.init_cache(cfg, 2, 8, "cpu", enc_len=5)
    for c in cache["blocks"].values():
        if "xk" in c:
            assert tuple(c["xk"].shape) == (cfg.n_periods, 2, 5, cfg.n_kv_heads, cfg.hd)
    with pytest.raises(ValueError, match="paged"):
        M.init_paged_pool(cfg, 2, 9, 16, 4, "cpu")


@pytest.mark.parametrize("name", NAMES)
def test_workers_and_serve_cli_refuse_cross_attention(name):
    """The port's RolloutWorker and serve CLI refuse audio and VLM configs,
    saying why; the JAX worker cannot serve them either (its ``init_cache``
    asserts that a cross-attention cache needs encoder output)."""
    jcfg, cfg, jparams, params = _models(name)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        RolloutWorker(cfg, params, capacity=16, max_slots=2, device="cpu")
    with pytest.raises(NotImplementedError, match="cross-attention"):
        RolloutWorker(cfg, params, capacity=16, max_slots=2, paged=False, device="cpu")
    with pytest.raises(AssertionError, match="cross-attention cache needs encoder output"):
        JaxWorker(jcfg, jparams, capacity=16, max_slots=2)
    with pytest.raises(SystemExit) as err:
        serve.main(["--device", "cpu", "--arch", name.replace("_", "-")])
    assert err.value.code == 2
