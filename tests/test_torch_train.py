"""PyTorch port, LM training: lm_loss, remat, the schedule, the optimizer,
train_step, checkpoint resume and the batch readers, held against the JAX
package on the CPU (tiny config, float32, parameters from the JAX
initialisers bridged by weights.from_jax; each JAX function jitted once per
module).

Tolerances:
- lm_loss's loss dict within 1e-5 relative; its gradients per leaf
  |port - JAX| <= 1e-5 + 1e-4 * max |JAX|;
- the optimizer on JAX's own gradients, 3 updates: |port - optax| <=
  1e-6 * (1 + |p|);
- train_step, 3 steps (the first has lr 0): every step's losses within
  1e-5 relative, so step 3's loss holds step 2's update to JAX's; the
  parameters after them within 4 lr + 1e-6 absolute: AdamW's update is
  about lr * sign(g) per step, so an element whose gradient is near 0 can
  move by lr either way; bf16 compute within 2e-2 relative of JAX's bf16
  loss;
- remat modes, resume after a checkpoint and the batch readers: equal.
"""

import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fireredtts2_tpu.config import tiny_engine_config as j_tiny
from fireredtts2_tpu.models.lm.model import init_draft_head as j_init_draft
from fireredtts2_tpu.models.lm.model import init_lm_params as j_init_lm
from fireredtts2_tpu.models.lm.model import lm_loss as j_lm_loss
from fireredtts2_tpu.train import loop as jloop
from fireredtts2_tpu.train import step as jstep

from fireredtts2_tpu_torch.config import tiny_engine_config as t_tiny
from fireredtts2_tpu_torch.models.lm.model import lm_loss as t_lm_loss
from fireredtts2_tpu_torch.train import loop as tloop
from fireredtts2_tpu_torch.train import step as tstep
from fireredtts2_tpu_torch.weights import from_jax

from _torch_parity import one_torch_thread, to_t  # noqa: F401

B, S = 4, 32
LR = 1e-3


@jax.jit
def _depth_draw(key, mask):
    b, s = mask.shape[:2]
    flat = jnp.roll(mask[:, :, 0], -1, axis=1).at[:, -1].set(False)
    flat = flat.reshape(-1).astype(jnp.float32)
    probs = flat / jnp.maximum(flat.sum(), 1.0)
    return jax.random.choice(key, b * s, shape=(max(b * s // 8, 1),),
                             replace=True, p=probs)


def jax_depth_draw(key, mask: np.ndarray) -> np.ndarray:
    """The depth subset JAX's lm_loss draws from `key` for this mask."""
    return np.asarray(_depth_draw(key, jnp.asarray(mask)))


def leaves_close(got: dict, want: dict, rel: float, abs_: float = 0.0,
                 path: str = ""):
    for k, w in want.items():
        if isinstance(w, dict):
            leaves_close(got[k], w, rel, abs_, f"{path}{k}.")
            continue
        g = got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k]
        w = np.asarray(w)
        tol = abs_ + rel * float(np.abs(w).max())
        assert np.abs(g - w).max() <= tol, (path + k, np.abs(g - w).max(), tol)


def requires_grad(tree):
    return tstep.tree_map(lambda p: p.clone().requires_grad_(True), tree)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, JAX params, their bridge, one batch)."""
    jcfg, tcfg = j_tiny().llm, t_tiny().llm
    jlm = jax.jit(lambda k: j_init_lm(k, jcfg, jnp.float32))(
        jax.random.PRNGKey(0))
    tok, msk = next(jloop.synthetic_batches(jcfg, jloop.TrainConfig(
        batch_size=B, seq_len=S), seed=3))
    return jcfg, tcfg, jlm, from_jax(jlm), tok, msk


@pytest.fixture(scope="module")
def jax_loss_grad():
    """lm_loss's value and gradient, jitted once per config variant."""
    cache = {}

    def get(cfg):
        key = repr(cfg)
        if key not in cache:
            def f(p, t, m, idx):
                def loss(q):
                    o = j_lm_loss(q, cfg, t, m, None, depth_indices=idx)
                    return o["loss"], o
                return jax.value_and_grad(loss, has_aux=True)(p)
            cache[key] = jax.jit(f)
        return cache[key]
    return get


@pytest.mark.parametrize("variant", ["text_loss", "no_text_loss", "draft_head"])
def test_lm_loss_and_grads_match_jax(setup, jax_loss_grad, variant):
    jcfg, tcfg, jlm, tlm, tok, msk = setup
    if variant == "no_text_loss":
        jcfg = dataclasses.replace(jcfg, use_text_loss=False)
        tcfg = dataclasses.replace(tcfg, use_text_loss=False)
    if variant == "draft_head":
        jcfg = dataclasses.replace(jcfg, depth_draft_head=True)
        tcfg = dataclasses.replace(tcfg, depth_draft_head=True)
        draft = j_init_draft(jax.random.PRNGKey(5), jcfg, jnp.float32)
        draft["pos"] = jax.random.normal(jax.random.PRNGKey(6),
                                         draft["pos"].shape) * 0.02
        jlm = {**jlm, "depth_draft": draft}
        tlm = {**tlm, "depth_draft": from_jax(draft)}
    idx = jax_depth_draw(jax.random.PRNGKey(1), msk)
    (_, jout), jg = jax_loss_grad(jcfg)(jlm, jnp.asarray(tok), jnp.asarray(msk),
                                        jnp.asarray(idx))
    tp = requires_grad(tlm)
    tout = t_lm_loss(tp, tcfg, to_t(tok), to_t(msk), depth_indices=to_t(idx))
    assert set(tout) == set(jout)
    assert ("draft_loss" in tout) == (variant == "draft_head")
    for k, v in jout.items():
        np.testing.assert_allclose(float(tout[k].detach()), float(v), rtol=1e-5,
                                   err_msg=k)
    leaves = tstep.tree_leaves(tp)
    grads = torch.autograd.grad(tout["loss"], leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    leaves_close(tstep.tree_unflatten(tp, grads), jg, rel=1e-4, abs_=1e-5)


def test_lm_loss_draw_is_seeded_and_survives_no_weight(setup):
    _, tcfg, _, tlm, tok, msk = setup
    out = [t_lm_loss(tlm, tcfg, to_t(tok), to_t(msk),
                     tstep.depth_generator(0, 7, "cpu"))["depth_loss"]
           for _ in range(2)]
    assert torch.equal(out[0], out[1])
    text_only = np.zeros_like(msk)
    text_only[..., -1] = True          # no audio frame: no weighted position
    o = t_lm_loss(tlm, tcfg, to_t(tok), to_t(text_only),
                  tstep.depth_generator(0, 0, "cpu"))
    assert float(o["depth_loss"]) == 0.0 and float(o["c0_loss"]) == 0.0
    assert torch.isfinite(o["loss"])


def test_remat_modes_equal_and_keep_less(setup):
    """none / full / dots: equal loss and gradients. What the forward keeps
    for backward must be ordered full < dots < none. Saved-tensor hooks see
    the packs outside a checkpointed layer only (the checkpoint's own hooks
    are innermost), so they count full and dots alike, below none; the
    kept bytes (profiler) tell the three apart."""
    _, tcfg, _, tlm, tok, msk = setup
    idx = to_t(jax_depth_draw(jax.random.PRNGKey(2), msk))
    res = {}
    for mode in ("", "full", "dots"):
        cfg = dataclasses.replace(tcfg, train_remat=mode)
        tp = requires_grad(tlm)
        packs = [0]

        def pack(t):
            packs[0] += 1
            return t
        # the net bytes the forward leaves allocated: what it keeps for
        # backward, its outputs included (the profiler's CPU accounting)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                profile(activities=[ProfilerActivity.CPU],
                        profile_memory=True) as prof:
            out = t_lm_loss(tp, cfg, to_t(tok), to_t(msk), depth_indices=idx)
        kept = sum(e.self_cpu_memory_usage for e in prof.key_averages())
        grads = torch.autograd.grad(out["loss"], tstep.tree_leaves(tp))
        res[mode or "none"] = (out, grads, packs[0], kept)
    base_out, base_grads = res["none"][:2]
    for mode in ("full", "dots"):
        out, grads = res[mode][:2]
        for k in base_out:
            assert torch.equal(out[k], base_out[k]), (mode, k)
        for g, h in zip(grads, base_grads):
            torch.testing.assert_close(g, h, rtol=1e-6, atol=1e-9)
    packs = {m: r[2] for m, r in res.items()}
    kept = {m: r[3] for m, r in res.items()}
    assert packs["full"] == packs["dots"] < packs["none"], packs
    assert kept["full"] < kept["dots"] < kept["none"], kept


def test_remat_rejects_unknown_mode():
    from fireredtts2_tpu_torch.ops.remat import remat_layer
    with pytest.raises(ValueError, match="remat mode"):
        remat_layer(lambda x: x, "all")


@pytest.mark.parametrize("decay", ["linear", "constant", "exponential", "cosine"])
def test_schedule_matches_jax(decay):
    j = jstep.warmup_decay_schedule(1e-3, 3, 10, decay)
    t = tstep.warmup_decay_schedule(1e-3, 3, 10, decay)
    for s in range(13):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{decay} step {s}")
    assert t(0) == 0.0


def optax_update(opt):
    """One optax update of `opt`, jitted (eager, its small ops would each
    compile on their first call, at ten times the cost)."""
    def update(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    return jax.jit(update)


# a subtree of JAX's gradients: every kind of leaf (stacked layer weights,
# biases at 0, norms at 1, tables, heads) at a small compile cost
OPT_LEAVES = (("backbone", "wq"), ("backbone", "bk"), ("decoder", "attn_norm"),
              ("text_embeddings",), ("projection",), ("audio_head",))


def subtree(tree):
    out = {}
    for path in OPT_LEAVES:
        node, dst = tree, out
        for k in path[:-1]:
            node, dst = node[k], dst.setdefault(k, {})
        dst[path[-1]] = node[path[-1]]
    return out


@pytest.mark.parametrize("norm_factor", [0.5, 2.0], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax_on_jax_grads(setup, jax_loss_grad, norm_factor):
    """3 updates of a parameter subtree on JAX's own gradients (scaled per
    step), max_grad_norm below the gradients' norm (clipping active) or
    above it."""
    jcfg, _, jlm, tlm, tok, msk = setup
    idx = jax_depth_draw(jax.random.PRNGKey(1), msk)
    (_, _), jg = jax_loss_grad(jcfg)(jlm, jnp.asarray(tok), jnp.asarray(msk),
                                     jnp.asarray(idx))
    jg, jp0 = subtree(jg), subtree(jlm)
    max_norm = norm_factor * float(optax.global_norm(jg))
    jopt = jstep.make_optimizer(LR, 1, 10, 0.01, max_norm)
    topt = tstep.make_optimizer(LR, 1, 10, 0.01, max_norm)

    jupdate = optax_update(jopt)
    jp, jst = jp0, jopt.init(jp0)
    tp = tstep.tree_map(torch.clone, subtree(tlm))
    tst = topt.init(tp)
    tg = from_jax(jg)
    for k in range(3):
        jp, jst = jupdate(jax.tree.map(lambda x: x * (1.0 + 0.5 * k), jg),
                          jst, jp)
        g = tstep.tree_map(lambda x: x * (1.0 + 0.5 * k), tg)
        tst, norm = topt.step(tp, g, tst)
        assert torch.equal(norm, tstep.global_norm(tstep.tree_leaves(g)))
    assert tst["count"] == 3
    ok = tstep.tree_map(lambda a, b: bool(np.all(
        np.abs(a.numpy() - np.asarray(b)) <= 1e-6 * (1 + np.abs(np.asarray(b))))),
        tp, jp)
    assert all(tstep.tree_leaves(ok)), ok
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(jp0)))
    assert moved > 0.5 * LR


N_STEPS = 3


@pytest.fixture(scope="module")
def jax_train_steps(setup, jax_loss_grad):
    """3 steps of JAX's train_step at grad_accum 2 (jitted), and of its
    grad_accum 1 body: lm_loss's value_and_grad (compiled once for the
    loss test) and the optimizer's update; with the depth subsets their
    keys draw."""
    jcfg, _, jlm, _, _, _ = setup
    opt = jstep.make_optimizer(LR, 1, 10, 0.01, 1.0)
    batches = list(zip(range(N_STEPS), jloop.synthetic_batches(
        jcfg, jloop.TrainConfig(batch_size=B, seq_len=S), seed=4)))
    fn2 = jax.jit(partial(jstep.train_step, cfg=jcfg, optimizer=opt,
                          grad_accum=2))
    update = optax_update(opt)

    def step1(state, tok, msk, key):
        (_, m), g = jax_loss_grad(jcfg)(state.params, tok, msk, jnp.asarray(
            jax_depth_draw(key, np.asarray(msk))))
        params, opt_state = update(g, state.opt_state, state.params)
        return (jstep.TrainState(params, opt_state, state.step + 1),
                dict(m, grad_norm=optax.global_norm(g)))

    out = {}
    for k, fn in ((1, step1), (2, fn2)):
        state = jstep.TrainState(jlm, opt.init(jlm), jnp.zeros((), jnp.int32))
        metrics, draws = [], []
        for i, (tok, msk) in batches:
            key = jax.random.fold_in(jax.random.PRNGKey(0), i)
            keys = [key] if k == 1 else [jax.random.fold_in(key, j)
                                         for j in range(k)]
            mb = B // k
            draws.append([jax_depth_draw(kk, msk[j * mb:(j + 1) * mb])
                          for j, kk in enumerate(keys)])
            state, m = fn(state, jnp.asarray(tok), jnp.asarray(msk), key)
            metrics.append({n: float(v) for n, v in m.items()})
        out[k] = (state.params, metrics, draws)
    return out, [b for _, b in batches]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(setup, jax_train_steps, grad_accum):
    """Step 3's loss is taken after step 2's update, the first with lr > 0:
    it sees the update train_step applies."""
    _, tcfg, _, tlm, _, _ = setup
    ref, batches = jax_train_steps
    jparams, jmetrics, draws = ref[grad_accum]
    opt = tstep.make_optimizer(LR, 1, 10, 0.01, 1.0)
    state = tstep.init_train_state(tlm, opt)
    for i, (tok, msk) in enumerate(batches):
        state, m = tstep.train_step(
            state, to_t(tok), to_t(msk), cfg=tcfg, optimizer=opt,
            grad_accum=grad_accum, depth_indices=[to_t(d) for d in draws[i]])
        assert set(m) == set(jmetrics[i])
        for n, v in jmetrics[i].items():
            np.testing.assert_allclose(float(m[n]), v, rtol=1e-5,
                                       err_msg=f"step {i} {n}")
    assert jmetrics[2]["loss"] != jmetrics[1]["loss"]
    assert state.step == N_STEPS and state.opt_state["count"] == N_STEPS
    leaves_close(state.params, jparams, rel=0.0, abs_=4 * LR + 1e-6)


def test_train_step_bf16_compute_matches_jax(setup):
    jcfg, tcfg, jlm, tlm, tok, msk = setup
    key = jax.random.PRNGKey(9)
    jout = jax.jit(partial(jstep.eval_step, cfg=jcfg,
                           compute_dtype=jnp.bfloat16))(
        jlm, jnp.asarray(tok), jnp.asarray(msk), key)
    opt = tstep.make_optimizer(LR, 1, 10)
    state = tstep.init_train_state(tlm, opt)
    state, m = tstep.train_step(state, to_t(tok), to_t(msk), cfg=tcfg,
                                optimizer=opt, compute_dtype=torch.bfloat16,
                                depth_indices=[to_t(jax_depth_draw(key, msk))])
    assert all(p.dtype == torch.float32 for p in tstep.tree_leaves(state.params))
    np.testing.assert_allclose(float(m["loss"]), float(jout["loss"]), rtol=2e-2)
    assert torch.isfinite(m["grad_norm"]) and float(m["grad_norm"]) > 0


def test_resume_equals_unbroken_run(setup, tmp_path):
    _, tcfg, _, tlm, _, _ = setup
    batches = [tuple(map(to_t, b)) for _, b in zip(range(4), tloop.synthetic_batches(
        tcfg, tloop.TrainConfig(batch_size=2, seq_len=16), seed=5))]
    opt = tstep.make_optimizer(LR, 1, 10)

    def run(state, bs):
        for tok, msk in bs:
            state, _ = tstep.train_step(state, tok, msk, cfg=tcfg, optimizer=opt,
                                        seed=11)
        return state

    straight = run(tstep.init_train_state(tlm, opt), batches)
    half = run(tstep.init_train_state(tlm, opt), batches[:2])
    path = tloop.save_checkpoint(str(tmp_path), half)
    assert tloop.latest_checkpoint(str(tmp_path)) == path
    resumed = tloop.restore_checkpoint(path, tstep.init_train_state(tlm, opt))
    assert resumed.step == 2 and resumed.opt_state["count"] == 2
    resumed = run(resumed, batches[2:])
    for a, b in zip(tstep.tree_leaves(straight.params),
                    tstep.tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    for key in ("mu", "nu"):
        for a, b in zip(tstep.tree_leaves(straight.opt_state[key]),
                        tstep.tree_leaves(resumed.opt_state[key])):
            assert torch.equal(a, b)


def test_batch_readers_match_jax(setup, tmp_path):
    jcfg, tcfg, _, _, _, _ = setup
    rng = np.random.default_rng(0)
    path = tmp_path / "shard.jsonl"
    with open(path, "w") as f:
        for n in range(5):
            f.write(json.dumps({
                "text_tokens": rng.integers(1, 300, 3 + n * 4).tolist(),
                "audio_tokens": rng.integers(0, 64, (n * 5, 4)).tolist()}) + "\n")
    jt = jloop.TrainConfig(batch_size=2, seq_len=16)
    tt = tloop.TrainConfig(batch_size=2, seq_len=16)
    for reader_j, reader_t in (
            (jloop.jsonl_batches(str(path), jcfg, jt),
             tloop.jsonl_batches(str(path), tcfg, tt)),
            (jloop.synthetic_batches(jcfg, jt, 2),
             tloop.synthetic_batches(tcfg, tt, 2))):
        for _ in range(4):   # past the file's end: the epoch loops
            (a, m), (b, n) = next(reader_j), next(reader_t)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(m, n)
