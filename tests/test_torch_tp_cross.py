"""The tensor-parallel cross-attention split, every shard on the CPU, against
the JAX package: whisper-medium's audio encoder-decoder and
llama-3.2-vision-11b's gated cross-attention through the model API.

Configs and params are ``tests/test_torch_encoders.py``'s: whisper reduced
(2 periods of ``dec+mlp``, 2 encoder layers over 32 frames; d 256, 4 heads
of 64, MHA, d_ff 512) and the VLM reduced at ``n_heads=8, n_kv_heads=4``
(G 2, so that degree 4 still cuts: a shard holds one kv head and the two q
heads that read it), every ``xgate`` set to 0.7 in both packages' params,
embeddings drawn with numpy in the config's dtype.  At degree 2 and 4:

  * the encoder on a mesh (attention on the shard's heads, the MLP on its
    ``d_ff``, the partials summed; ``enc_norm`` replicated) against the
    JAX ``_encoder``;
  * ``forward_full(mesh=, capacity=)`` over the embeddings, then three
    decode steps (the last with a lane masked) through each shard's cross
    K/V: logits, and every cache leaf gathered on its kv heads, against the
    JAX ``forward_full`` and ``decode_step``; whisper's positions are
    sinusoidal and take no RoPE;
  * the rollout worker still refuses both at every degree, as the JAX worker
    has no admission path for cross-attention.

Tolerances are ``tests/test_torch_tp_mixers.py``'s: 2e-5 for cache leaves
and the encoder's output, ``LOGIT_TOL`` (5e-6) for logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.distributed.sharding import (gather_cache, shard_config, shard_params,
                                              tp_split)
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import model as M

from _torch_parity import one_torch_thread  # noqa: F401
from test_torch_encoders import _batch, _models
from test_torch_tp import KW, LOGIT_TOL, _mesh
from test_torch_tp_mixers import _close

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODELS = {"whisper": ("whisper_medium", {}),
          "vlm": ("llama_3_2_vision_11b", dict(n_heads=8, n_kv_heads=4))}
CASES = [(m, d) for m in MODELS for d in (2, 4)]
IDS = [f"{m}-d{d}" for m, d in CASES]


def _model(name):
    arch, kw = MODELS[name]
    return _models(arch, **kw)


@pytest.mark.parametrize("d", [2, 4])
def test_encoder_on_mesh_matches_jax(d):
    jcfg, cfg, jparams, params = _model("whisper")
    split = tp_split(cfg, d)
    assert split.attn and split.mlp
    mesh = _mesh(d)
    jb, tb = _batch(cfg, np.zeros((2, 1), np.int64))
    outs = M._tp_encoder(shard_config(cfg, split), split, mesh,
                         shard_params(params, split, mesh), tb["encoder_embeds"])
    want = JM._encoder(jcfg, jparams, jb["encoder_embeds"])
    for out in outs:                                  # every shard's copy
        _close(out, want)


@pytest.mark.parametrize("name,d", CASES, ids=IDS)
def test_forward_and_decode_on_mesh_match_jax(name, d):
    """Admission of two lanes over their embeddings on a mesh, then three
    decode steps: logits and every cache leaf against the JAX package."""
    jcfg, cfg, jparams, params = _model(name)
    split = tp_split(cfg, d)
    assert split.attn and cfg.n_kv_heads // d >= 1
    mesh = _mesh(d)
    ps = shard_params(params, split, mesh)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9))
    jb, tb = _batch(cfg, tokens)
    logits, _, caches = M.forward_full(cfg, ps, tb, capacity=16, mesh=mesh)
    jlogits, _, jcache = JM.forward_full(jcfg, jparams, jb, capacity=16)
    assert len(caches) == d and logits.shape == (2, 9, cfg.vocab)
    _close(logits, jlogits, LOGIT_TOL)
    kv = cfg.n_kv_heads // d
    for c in caches:
        for key, leaves in c["blocks"].items():
            assert all(leaf.shape[-2] == kv for leaf in leaves.values()), key
            if "xk" in leaves:
                assert leaves["xk"].shape[2] == (cfg.encoder_seq or cfg.image_seq)
    for i, act in enumerate([None, None, np.array([False, True])]):
        tok = np.array([[5 + i], [17 + i]])
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok, jnp.int32),
                                         active=None if act is None else jnp.asarray(act))
        logits, caches = M.decode_step(cfg, ps, caches, torch.tensor(tok), mesh=mesh,
                                       active=None if act is None else torch.tensor(act))
        _close(logits, jlogits, LOGIT_TOL)
    cache = gather_cache(caches, split)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for key, c in jcache["blocks"].items():
        for leaf, want in c.items():
            _close(cache["blocks"][key][leaf], want)


@pytest.mark.parametrize("name,d", CASES, ids=IDS)
def test_worker_still_refuses_cross_attention_on_a_mesh(name, d):
    _, cfg, _, params = _model(name)
    for paged in (True, False):
        with pytest.raises(NotImplementedError, match="cross-attention"):
            RolloutWorker(cfg, params, mp=d, mesh=_mesh(d), paged=paged, **KW)
