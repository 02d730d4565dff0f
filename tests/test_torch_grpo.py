"""GRPO's loss and gradients in the port against the JAX package's (jamba
through the Mamba scan's backward too), and the chunked mLSTM's gradients
against its own recurrence.

Weights are the JAX package's ``init_params`` carried across with
``from_jax``; configs are ``reduced(n_periods=1)`` (f32); batches are drawn
with numpy.  Tolerances, float32: the loss and its metrics 1e-5; every
gradient leaf within 1e-5 of max(1, max |JAX gradient|) (sums over the batch
and the sequence in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_and_port, to_np, tree_paths
from _torch_parity import one_torch_thread  # noqa: F401
from repro.models import model as JM
from repro.rl import grpo as JG
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.rl import grpo as G

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _grpo_batch(jcfg, jparams, B=4, S=24, seed=2):
    """tokens, a response mask, advantages of both signs, and old logprobs
    near the policy's (the JAX model's, plus noise), so that some ratios clip."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(5, jcfg.vocab, (B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.float32)
    for b in range(B):
        mask[b, 3:S - 1 - b] = 1.0
    adv = rng.standard_normal(B).astype(np.float32)
    logits, _ = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    old = np.asarray(JG.token_logprobs(logits, jnp.asarray(tokens)))
    old = (old + 0.3 * rng.standard_normal(old.shape)).astype(np.float32)
    return {"tokens": tokens, "loss_mask": mask, "advantages": adv, "old_logprobs": old}


@pytest.mark.parametrize("name", ["smollm_135m", "qwen2_moe_a2_7b", "xlstm_350m",
                                  "jamba_v0_1_52b"])
def test_grpo_loss_value_metrics_and_gradients_match_jax(name):
    """The loss (remat on), its metrics and the gradient of every parameter
    leaf: dense, MoE with shared experts and the aux loss, the xLSTM mixers,
    and jamba's Mamba mixers (the scan's backward; the JAX package
    differentiates its chunked scan) beside attention and MoE."""
    jcfg, cfg, jparams, params = jax_and_port(name, n_periods=1)
    batch = _grpo_batch(jcfg, jparams)
    gcfg = G.GRPOConfig(group_size=2)
    jgcfg = JG.GRPOConfig(group_size=2)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: JG.grpo_loss(jcfg, jgcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    loss, metrics, grads = G.value_and_grad(
        lambda p: G.grpo_loss(cfg, gcfg, p, {k: torch.tensor(v) for k, v in batch.items()}),
        params)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    for k in ("pg_loss", "aux_loss", "approx_kl"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 1e-5, k
    if name == "qwen2_moe_a2_7b":
        assert float(metrics["aux_loss"]) > 0
    want = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    got = {k: to_np(v) for k, v in tree_paths(grads).items()}
    assert got.keys() == want.keys()
    held = 0
    for k, g in got.items():
        assert np.isfinite(g).all(), k
        assert np.abs(g).max() > 0, k     # every leaf the loss reaches has a gradient
        if name == "xlstm_350m" and not np.isfinite(want[k]).all():
            continue                      # the JAX mLSTM's NaN (ROADMAP.md Queue 3)
        limit = 1e-5 * max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(g, want[k], atol=limit, rtol=0, err_msg=k)
        held += 1
    assert held >= (10 if name == "xlstm_350m" else len(got))
    for leaf in M.tree_leaves(params):
        assert not leaf.requires_grad     # the caller's tensors never require grad


def test_mlstm_gradient_is_the_step_recurrences():
    """The chunked mLSTM's gradients (every leaf of the layer and the input)
    against autograd through the one-token recurrence, the same function in
    exact arithmetic, over S 40 (chunks of 32 and a padded one), within 1e-5
    of max(1, max |step gradient|).  The JAX package's chunked form gives NaN
    here (ROADMAP.md Queue 3), so the port holds itself to its own step."""
    cfg = get_config("xlstm_350m").reduced(n_periods=1)
    params = M.init_params(cfg, seed=0, device="cpu")
    p = {k: v[0].detach().requires_grad_() for k, v in
         params["blocks"]["00_mlstm"]["mixer"].items()}
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 40, cfg.d_model))
                     .astype(np.float32), requires_grad=True)
    w = torch.tensor(np.random.default_rng(4).standard_normal((2, 40, cfg.d_model))
                     .astype(np.float32))
    full, _ = TL.mlstm_full(p, x, cfg)
    st = TL.fresh_mlstm_state(2, cfg.n_heads, cfg.xlstm_expand * cfg.d_model // cfg.n_heads,
                              "cpu")
    steps = []
    for t in range(40):
        o, st = TL.mlstm_step(p, x[:, t:t + 1], cfg, st)
        steps.append(o)
    step = torch.cat(steps, dim=1)
    np.testing.assert_allclose(full.detach().numpy(), step.detach().numpy(), atol=2e-5, rtol=0)
    inputs = (x, *p.values())
    g_full = torch.autograd.grad((full * w).sum(), inputs)
    g_step = torch.autograd.grad((step * w).sum(), inputs)
    for name, a, b in zip(("x", *p), g_full, g_step):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, err_msg=name,
                                   atol=1e-5 * max(1.0, float(b.abs().max())))


def test_grpo_loss_on_jamba_is_the_same_without_grad():
    """The jamba loss under ``torch.no_grad`` is finite and equals the one
    ``value_and_grad`` returns (the scan's autograd Function runs the same
    forward with and without a backward to come), and every leaf of the
    caller's params is left without a gradient."""
    cfg = get_config("jamba_v0_1_52b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(5, cfg.vocab, (2, 12)).astype(np.int32))
    batch = {"tokens": tokens, "loss_mask": torch.ones(2, 12),
             "advantages": torch.tensor([1.0, -1.0]),
             "old_logprobs": torch.tensor(rng.standard_normal((2, 12)).astype(np.float32))}
    with torch.no_grad():
        loss, _ = G.grpo_loss(cfg, G.GRPOConfig(), params, batch)
    assert torch.isfinite(loss)
    grad_loss, _, grads = G.value_and_grad(
        lambda p: G.grpo_loss(cfg, G.GRPOConfig(), p, batch), params)
    assert float(grad_loss) == float(loss)
    assert all(torch.isfinite(g).all() for g in M.tree_leaves(grads))
    assert not any(t.requires_grad or t.grad is not None for t in M.tree_leaves(params))


@pytest.mark.parametrize("masked", [True, False])
def test_lm_train_step_matches_jax(masked):
    """Two steps of the plain next-token step on smollm, with and without a
    loss mask: the loss within 1e-5, and the parameters after each step
    within 2 x lr everywhere and 1e-5 on all but 0.1% of the elements
    (Adam's first steps move an element by about lr whatever the size of its
    gradient, so rounding of near-zero gradients shows at lr's scale)."""
    from repro.rl.optimizer import AdamW as JaxAdamW
    from repro_torch.rl.optimizer import AdamW

    jcfg, cfg, jparams, params = jax_and_port("smollm_135m", n_periods=1)
    rng = np.random.default_rng(6)
    lr = 1e-3
    jstep = JG.make_lm_train_step(jcfg, JaxAdamW(lr=lr))
    step = G.make_lm_train_step(cfg, AdamW(lr=lr))
    jstate, state = JaxAdamW(lr=lr).init(jparams), AdamW(lr=lr).init(params)
    for it in range(2):
        batch = {"tokens": rng.integers(5, cfg.vocab, (3, 20)).astype(np.int32)}
        if masked:
            batch["loss_mask"] = (rng.random((3, 20)) < 0.6).astype(np.float32)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, {k: torch.tensor(v) for k, v in batch.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5, it
        want = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
        off, total = 0, 0
        for k, g in tree_paths(params).items():
            d = np.abs(to_np(g) - want[k])
            assert d.max() <= 2 * lr, (it, k)
            off += int((d > 1e-5).sum())
            total += d.size
        assert off <= 1e-3 * total, f"step {it}: {off} of {total} elements off by more than 1e-5"
        assert int(state.step) == it + 1
