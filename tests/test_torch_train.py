"""The port's training plane against the JAX package's.

Inputs are drawn with numpy from a seed; weights are the JAX package's
``init_params`` carried across with ``from_jax``; configs are ``reduced()``
(f32).  Tolerances, all float32:

  * flash attention: forward 2e-5, dq/dk/dv 5e-5 (tests/test_kernels.py's),
    the same blocks and sums in the same order; at S 2,048, whose gradients
    reach ~40, dq/dk/dv within 5e-5 of max(1, max |JAX gradient|);
  * token logprobs 2e-5 (GRPO's loss and gradients: tests/test_torch_grpo.py);
  * AdamW on identical gradients: 1e-6 in f32, one bf16 ulp of the
    parameter's scale in bf16 (a rounding at a tie may differ);
  * a whole trainer update: metrics 1e-5; parameters within 2 x lr, and
    99.9% of elements within 1e-5.  Adam's first steps move an element by
    about lr x g / |g|, so f32 rounding of a near-zero gradient's sign can
    move it by up to 2 x lr; gradients and the optimizer are held tightly
    above, one at a time.
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (ONE_THREAD_ENV, hold_params, jax_and_port, spread_records,
                           to_np, tree_paths)
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models.flash import flash_attention as jax_flash
from repro.rl import grpo as JG
from repro.rl import loop as JL
from repro.rl.optimizer import AdamW as JaxAdamW
from repro_torch.configs import get_config
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models.flash import flash_attention
from repro_torch.params import from_jax
from repro_torch.rl import data as D
from repro_torch.rl import grpo as G
from repro_torch.rl import loop as TLoop
from repro_torch.rl.optimizer import AdamW, AdamWState

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ flash backward

def _flash_case(S, T, window, seed, B=2, KV=2, G_=3, hd=32, pad_rows=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G_, S, hd), np.float32)
    k = rng.standard_normal((B, T, KV, hd), np.float32)
    v = rng.standard_normal((B, T, KV, hd), np.float32)
    dout = rng.standard_normal((B, KV, G_, S, hd), np.float32)
    qp, kp = np.arange(S, dtype=np.int32), np.arange(T, dtype=np.int32)
    if pad_rows:
        qp[-pad_rows:] = -1               # padding query rows: lse 0, no gradient
        kp[-pad_rows:] = np.iinfo(np.int32).max   # padded keys, as _pad_to pads them
    return q, k, v, dout, qp, kp


def _flash_both(q, k, v, dout, qp, kp, window, qb, kb):
    scale = 1 / math.sqrt(q.shape[-1])

    def jf(q_, k_, v_):
        return jax_flash(q_, k_, v_, jnp.asarray(qp), jnp.asarray(kp), scale, True, window, qb, kb)

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.tensor(qp), torch.tensor(kp), scale, True,
                          window, qb, kb)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout))
    return (np.asarray(jout), [np.asarray(g) for g in jgrads]), (out.detach().numpy(),
                                                                 [g.numpy() for g in grads])


@pytest.mark.parametrize("S,T,window", [(64, 64, 0), (100, 100, 0), (100, 100, 17),
                                        (33, 70, 0), (128, 128, 32)])
def test_flash_backward_matches_jax_grad(S, T, window):
    """dq/dk/dv of the port's autograd Function against ``jax.vjp`` of the
    JAX custom VJP, blocks of 32 (q) and 48 (kv): several blocks, a ragged
    tail."""
    case = _flash_case(S, T, window, S + T + window)
    (jout, jgrads), (out, grads) = _flash_both(*case, window, 32, 48)
    np.testing.assert_allclose(out, jout, atol=2e-5, rtol=0)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0, err_msg=f"d{name}")


def test_flash_backward_past_the_threshold_with_padding_rows():
    """S = T = 2,048 (``FLASH_THRESHOLD``) at the model's blocks (512 x 1024),
    the last 100 query rows padding (q_pos -1) and the last 100 keys padded
    (INT_MAX): every output and gradient is the JAX package's."""
    case = _flash_case(2048, 2048, 0, 7, B=1, KV=1, G_=2, hd=16, pad_rows=100)
    (jout, jgrads), (out, grads) = _flash_both(*case, 0, TL._QBLK, TL._KBLK)
    np.testing.assert_allclose(out, jout, atol=2e-5, rtol=0)
    for name, a, b in zip("qkv", grads, jgrads):     # sums of 2,048 terms: to scale
        np.testing.assert_allclose(a, b, atol=5e-5 * max(1.0, float(np.abs(b).max())),
                                   rtol=0, err_msg=f"d{name}")
    # a padding row's scores are all -1e30, a finite max: it attends to every
    # key alike, in both packages, and its gradient follows that average
    want_pad = case[2].mean(axis=1)[:, :, None, None]             # (B, KV, 1, 1, hd)
    np.testing.assert_allclose(out[..., -100:, :], np.broadcast_to(
        want_pad, out[..., -100:, :].shape), atol=2e-5, rtol=0)


def test_flash_saves_only_its_residuals():
    """What autograd keeps for the backward is (q, k, v, q_pos, kv_pos, out,
    lse): O(S), no per-block score or probability tensor."""
    q, k, v, _, qp, kp = _flash_case(256, 256, 0, 3, B=1, KV=2, G_=2, hd=16)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        flash_attention(tq, tk, tv, torch.tensor(qp), torch.tensor(kp), 0.25, True, 0, 64, 64)
    nbytes = sum(t.numel() * t.element_size() for t in saved)
    want = (2 * q.nbytes + k.nbytes + v.nbytes + qp.nbytes + kp.nbytes
            + q.nbytes // q.shape[-1])                     # q, k, v, pos, out, lse
    assert len(saved) == 7 and nbytes == want


# ------------------------------------------------------------------ GRPO pieces

def test_group_advantages_use_the_population_std():
    rewards = np.array([1.0, 0.0, 0.25, 0.0, 0.5, 0.5, 1.0, 0.0], np.float32)
    want = np.asarray(JG.group_advantages(jnp.asarray(rewards), 4))
    got = G.group_advantages(torch.tensor(rewards), 4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert abs(float(np.std(got[:4]) - 1.0)) < 1e-4            # ddof 0


def test_token_logprobs_and_chunked_match_jax():
    """``token_logprobs`` on full logits, and the chunked fused head at
    chunk 16 over S 50 (a ragged last chunk), against the JAX package's."""
    jcfg, cfg, jparams, params = jax_and_port("smollm_135m")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (3, 50)).astype(np.int32)
    jlogits, _ = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    want = np.asarray(JG.token_logprobs(jlogits, jnp.asarray(tokens)))
    logits, _ = M.forward_full(cfg, params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(G.token_logprobs(logits, torch.tensor(tokens)).numpy(), want,
                               atol=2e-5, rtol=0)
    jhidden, _ = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                                 return_hidden=True)
    want_c = np.asarray(JG.chunked_token_logprobs(jcfg, jparams, jhidden,
                                                  jnp.asarray(tokens), chunk=16))
    hidden, _ = M.forward_full(cfg, params, {"tokens": torch.tensor(tokens)},
                               return_hidden=True)
    got_c = G.chunked_token_logprobs(cfg, params, hidden, torch.tensor(tokens), chunk=16)
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_c.numpy(), want, atol=2e-5, rtol=0)
    assert not got_c[:, -1].any()


# ------------------------------------------------------------------ AdamW

@pytest.mark.parametrize("weight_decay,moment_dtype", [(0.0, "float32"), (0.1, "float32"),
                                                       (0.1, "bfloat16")])
def test_adamw_matches_jax_on_identical_gradients(weight_decay, moment_dtype):
    """Three steps on f32 and bf16 leaves with the global-norm clip engaged
    (gradient norm ~30 against 1.0): parameters, moments and the step."""
    rng = np.random.default_rng(4)
    shapes = {"w": ((8, 16), np.float32), "blk": {"v": ((5,), np.float32),
                                                  "h": ((6, 4), "bfloat16")}}
    flat = tree_paths(shapes)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in flat.items()}
    opts = [JaxAdamW(lr=1e-2, weight_decay=weight_decay, moment_dtype=moment_dtype),
            AdamW(lr=1e-2, weight_decay=weight_decay, moment_dtype=moment_dtype)]

    def nest(d):
        return {"w": d["w"], "blk": {"v": d["blk/v"], "h": d["blk/h"]}}

    jdt = {k: jnp.bfloat16 if dt == "bfloat16" else jnp.float32 for k, (_, dt) in flat.items()}
    tdt = {k: torch.bfloat16 if dt == "bfloat16" else torch.float32
           for k, (_, dt) in flat.items()}
    jp = nest({k: jnp.asarray(v, jdt[k]) for k, v in p0.items()})
    tp = nest({k: torch.tensor(v).to(tdt[k]) for k, v in p0.items()})
    js, ts = opts[0].init(jp), opts[1].init(tp)
    for step in range(3):
        g = {k: (3 * rng.standard_normal(flat[k][0])).astype(np.float32) for k in flat}
        g["w"][0, :4] = 1e-9                       # near-zero gradients ride along
        jp, js = opts[0].update(nest({k: jnp.asarray(v, jdt[k]) for k, v in g.items()}), js, jp)
        tp, ts = opts[1].update(nest({k: torch.tensor(v).to(tdt[k]) for k, v in g.items()}),
                                ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        for name, (got_t, want_t) in {"params": (tp, jp), "mu": (ts.mu, js.mu),
                                      "nu": (ts.nu, js.nu)}.items():
            for k, got in tree_paths(got_t).items():
                want = to_np(tree_paths(want_t)[k])
                if name == "params":
                    assert got.dtype == tdt[k]
                bf16 = got.dtype == torch.bfloat16
                limit = (2 ** -7 * max(1.0, float(np.abs(want).max())) if bf16 else 1e-6)
                np.testing.assert_allclose(to_np(got), want, atol=limit, rtol=0,
                                           err_msg=f"step {step} {name} {k}")
    want_mdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    assert all(m.dtype == want_mdt for m in M.tree_leaves(ts.mu))


def test_adamw_update_leaves_its_inputs_untouched():
    rng = np.random.default_rng(5)
    params = {"a": torch.tensor(rng.standard_normal((4, 4)).astype(np.float32)),
              "b": torch.tensor(rng.standard_normal(3).astype(np.float32)).bfloat16()}
    grads = {k: torch.randn_like(v.float()).to(v.dtype) for k, v in params.items()}
    opt = AdamW(lr=0.1, weight_decay=0.1)
    state = opt.init(params)
    state = AdamWState(state.step, {k: torch.randn_like(v) for k, v in state.mu.items()},
                       {k: torch.rand_like(v) for k, v in state.nu.items()})
    before = [t.clone() for t in (*params.values(), *grads.values(), state.step,
                                  *state.mu.values(), *state.nu.values())]
    new, new_state = opt.update(grads, state, params)
    after = [*params.values(), *grads.values(), state.step, *state.mu.values(),
             *state.nu.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not any(torch.equal(new[k], params[k]) for k in params)
    assert int(new_state.step) == 1 and int(state.step) == 0


# ------------------------------------------------------------------ the trainer

TCFG = dict(group_size=2, n_workers=2, seed=0, max_steps_per_traj=2)


@pytest.fixture(scope="module")
def trainers():
    """The JAX trainer and the port's (on the JAX weights) through one
    rollout, one update on its records, and one update on records with a
    reward spread; each package's results kept."""
    jcfg = jax_config("smollm_135m").reduced(n_periods=1)
    cfg = get_config("smollm_135m").reduced(n_periods=1)
    jtr = JL.HeddleTrainer(jcfg, JL.TrainerConfig(**TCFG))
    ttr = TLoop.HeddleTrainer(cfg, TLoop.TrainerConfig(**TCFG),
                              params=from_jax(jax.tree.map(np.asarray, jtr.params),
                                              device="cpu"), device="cpu")
    out = {}
    for tag, tr, rec_cls in (("jax", jtr, JL.RolloutRecord), ("port", ttr, TLoop.RolloutRecord)):
        tasks = D.sample_tasks(2, seed=0)
        records = tr.rollout(tasks)
        m1 = tr.update(records)
        p1 = {k: to_np(v) for k, v in tree_paths(tr.params).items()}
        m2 = tr.update(spread_records(tasks[0], rec_cls, D))
        p2 = {k: to_np(v) for k, v in tree_paths(tr.params).items()}
        out[tag] = dict(records=records, m1=m1, p1=p1, m2=m2, p2=p2, trainer=tr)
    return out


def test_trainer_rollout_records_equal_jax(trainers):
    j, t = trainers["jax"]["records"], trainers["port"]["records"]
    assert len(t) == len(j) == 4
    for a, b in zip(t, j):
        assert (a.tokens, a.prompt_len, a.reward, a.steps) == \
            (b.tokens, b.prompt_len, b.reward, b.steps)


@pytest.mark.parametrize("which", ["m1", "m2"])
def test_trainer_update_metrics_and_params_match_jax(trainers, which):
    """The update on the rollout's records, then on records with a reward
    spread (which must move the policy)."""
    j, t = trainers["jax"], trainers["port"]
    assert t[which].keys() == j[which].keys()
    for k, v in j[which].items():
        assert abs(t[which][k] - v) <= 1e-5, k
    hold_params(t["p" + which[1]], j["p" + which[1]], TLoop.TrainerConfig().lr)
    if which == "m2":
        assert abs(t["m2"]["pg_loss"]) > 1e-8
        assert any(np.abs(t["p2"][k] - t["p1"][k]).max() > 0 for k in t["p2"])


def test_update_is_functional_worker_weights_wait_for_the_sync():
    """A worker holds the trainer's tensors; an update leaves them bit for
    bit as they were (it makes new ones), and only the next rollout's sync
    hands the workers the new policy."""
    cfg = get_config("smollm_135m").reduced(n_periods=1)
    tr = TLoop.HeddleTrainer(cfg, TLoop.TrainerConfig(group_size=4, n_workers=1, seed=0),
                             device="cpu")
    w: RolloutWorker = tr.workers[0]
    before = {k: v.clone() for k, v in tree_paths(w.params).items()}
    held = tree_paths(w.params)
    m = tr.update(spread_records(D.sample_tasks(1, seed=0)[0], TLoop.RolloutRecord, D))
    assert abs(m["pg_loss"]) > 1e-8
    for k, v in tree_paths(w.params).items():
        assert v is held[k] and torch.equal(v, before[k]), k
        assert not v.requires_grad
    assert any(not torch.equal(v, before[k]) for k, v in tree_paths(tr.params).items())
    tr.rollout(D.sample_tasks(1, seed=1))
    assert all(a is b for a, b in zip(M.tree_leaves(w.params), M.tree_leaves(tr.params)))


# ------------------------------------------------------------------ the CLI

def _train(*args, **env):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
                               **ONE_THREAD_ENV, **env})


def test_train_cli_runs_on_the_cpu_when_asked(tmp_path):
    out = _train("--device", "cpu", "--iters", "2", "--group-size", "2",
                 "--tasks-per-iter", "2", "--checkpoint-dir", str(tmp_path),
                 "--checkpoint-every", "2")
    assert out.returncode == 0, out.stderr
    assert "on cpu" in out.stdout and "iter    2" in out.stdout
    assert (tmp_path / "step2").is_dir()


def test_train_cli_refuses_the_cpu_by_default_and_the_dry_run(capsys):
    """Without --device and with no card the CLI stops.  ``--dry-run`` is
    ported: it delegates to the port's dry run (launch/dryrun.py), which
    reckons the full config's train_4k step on the H100 layout with no
    card, exits 0 and prints its summary line; ``--multi-pod`` alone is
    refused."""
    out = _train("--iters", "1", CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0 and "CUDA" in out.stderr and "iter" not in out.stdout
    from repro_torch.launch import train
    assert train.main(["--dry-run", "--multi-pod"]) == 0
    printed = capsys.readouterr().out
    assert "[2x1x8] smollm-135m" in printed and "train_4k" in printed
    assert "dry-run: 1 ok, 0 skipped, 0 failed / 1 total" in printed
    with pytest.raises(SystemExit) as err:
        train.main(["--device", "cpu", "--multi-pod"])
    assert err.value.code == 2 and "needs --dry-run" in capsys.readouterr().err
