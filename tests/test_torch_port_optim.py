"""The port's capturable optimiser against the JAX package's, on the CPU.

``lr_schedule`` on ints and on 0-d count tensors against the optax schedules
at every count 0-40; ``StepGate`` on and off; ``set_lr_scale``; the
global-norm clip above and below its max; ``grad_accum_steps=2``; and
``adamw8bit``.  Each optimiser case runs 6 steps of both optimisers from the
same numpy parameters and gradients (two groups, one leaf of more than one
256-element block) and compares the parameters and the moments after every
step.

Tolerances: schedules 1e-6 relative; parameters and fp32 moments within
1e-5 of each tensor's largest magnitude (the same fp32 formulas, summed in
another order); 8-bit moments: the fp32 block scales within 1e-6 relative,
the int8 blocks equal -- without the clip.  With the clip the global norm is
summed in another order than XLA's, a last-bit difference that moves a
moment across a rounding boundary now and then (1 of 1024 elements in 6
steps): there at most 0.2% of the int8 elements may differ, by one count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_finetuning_tpu.training import optim as jopt

from diffusion_finetuning_tpu_torch.training import optim as topt

REL = 1e-5
STEPS = 6
NAMES = ["constant", "constant_with_warmup", "linear", "cosine"]


@pytest.mark.parametrize("name", NAMES)
def test_lr_schedule_on_ints_and_tensors(name):
    want = jopt.lr_schedule(name, 3e-4, num_warmup_steps=5, num_training_steps=30)
    got = topt.lr_schedule(name, 3e-4, num_warmup_steps=5, num_training_steps=30)
    counts = list(range(41))
    ref = [float(want(jnp.asarray(c, jnp.int32))) for c in counts]
    on_ints = [got(c) for c in counts]
    on_tensors = [got(torch.tensor(c)) for c in counts]
    assert all(isinstance(x, float) for x in on_ints)
    assert all(t.dtype == torch.float32 and t.shape == () for t in on_tensors)
    for values in (on_ints, [float(t) for t in on_tensors]):
        np.testing.assert_allclose(values, ref, rtol=1e-6, atol=1e-6 * 3e-4)


@pytest.mark.parametrize("on_after", [True, False])
def test_step_gate_matches_jax(on_after):
    jg, tg = jopt.StepGate(3, on_after), topt.StepGate(3, on_after)
    for c in range(8):
        want = float(jg(jnp.asarray(c, jnp.int32)))
        assert tg(c) == want and float(tg(torch.tensor(c))) == want
    assert topt.ParamGroup(lr=1.0, lr_gate=tg).cache_key() == topt.ParamGroup(
        lr=1.0, lr_gate=topt.StepGate(3, on_after)).cache_key()
    with pytest.raises(TypeError):
        topt.ParamGroup(lr=1.0, lr_gate=lambda c: 1.0).cache_key()


def _params():
    rng = np.random.default_rng(6)
    return {"unet_lora": {"a": {"up": rng.standard_normal((6, 2)).astype(np.float32),
                                "down": rng.standard_normal((2, 300)).astype(np.float32),
                                "scale": np.float32(0.7)}},
            "ti_embeddings": rng.standard_normal((7, 3)).astype(np.float32)}


def _trainable(tree):
    """(path, leaf) of a parameter tree's trainable leaves in the port's
    order (sorted keys, scale leaves left out)."""
    if not isinstance(tree, dict):
        return [((), tree)]
    return [((k,) + p, leaf) for k in sorted(tree) if k != "scale"
            for p, leaf in _trainable(tree[k])]


def _jax_moments(state):
    """{(kind, param path): array} of an optax state: adamw's mu/nu, or
    adamw8bit's m_q/m_s/v_q/v_s."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = [getattr(k, "name", getattr(k, "key", None)) for k in path]
        for kind in ("mu", "nu"):
            if kind in names:
                out[(kind, tuple(names[names.index(kind) + 1:]))] = np.asarray(leaf)
        if "moments" in names:
            out[(names[-1], tuple(names[names.index("moments") + 1:-1]))] = np.asarray(leaf)
    return out


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()) + 1e-30, f"{what}: {err}"


def _check_moments(st, sj, use_8bit, slack):
    want = _jax_moments(sj)
    for name, layout in st.layouts.items():
        paths = [(name,) + p for p, _ in _trainable(_params()[name])]
        moments = st.moments[name]
        if not use_8bit:
            for kind, key in (("mu", "m"), ("nu", "v")):
                for path, got in zip(paths, layout.views(moments[key])):
                    _close(got, want[(kind, path)], f"{kind} {path}")
            continue
        for kind in ("m_q", "v_q"):
            ref = np.concatenate([want[(kind, p)] for p in paths]).astype(np.int32)
            diff = np.abs(moments[kind].numpy().astype(np.int32) - ref)
            assert diff.max() <= (1 if slack else 0) and (diff > 0).mean() <= slack, kind
        for kind in ("m_s", "v_s"):
            ref = np.concatenate([want[(kind, p)] for p in paths])
            np.testing.assert_allclose(moments[kind].numpy(), ref, rtol=1e-6, err_msg=kind)


CASES = {  # case -> (optimizer kwargs, unet_lora's StepGate on_after, lr scale to set)
    "gate_on": (dict(max_grad_norm=0.5), True, None),
    "gate_off": (dict(max_grad_norm=0.5), False, None),
    "lr_scale": (dict(max_grad_norm=0.5, runtime_lr_scale=True), None, 0.25),
    "clip_above": (dict(max_grad_norm=0.5), None, None),
    "clip_below": (dict(max_grad_norm=1e3), None, None),
    "accum2": (dict(max_grad_norm=0.5, grad_accum_steps=2), None, None),
    "adamw8bit": (dict(use_8bit=True), None, None),
    "adamw8bit_accum2": (dict(use_8bit=True, grad_accum_steps=2), None, None),
    "adamw8bit_clip_accum2": (dict(max_grad_norm=0.5, use_8bit=True, grad_accum_steps=2),
                              None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    """Two groups (cosine with warm-up and constant, different decay), 6
    steps: the parameters and the moments after every step."""
    kw, on_after, lr_scale = CASES[case]
    groups = {}
    for mod in (jopt, topt):
        g = None if on_after is None else mod.StepGate(2, on_after)
        groups[mod] = {"unet_lora": mod.ParamGroup(lr=1e-3, schedule="cosine", warmup_steps=1,
                                                   total_steps=6, lr_gate=g),
                       "ti_embeddings": mod.ParamGroup(lr=5e-3, weight_decay=0.0)}
    params = _params()
    tx = jopt.multi_group_optimizer(groups[jopt], **kw)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    sj = tx.init(pj)
    opt = topt.multi_group_optimizer(groups[topt], **kw)
    pt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    for _, leaf in _trainable(pt):
        leaf.requires_grad_(True)
    st = opt.init(pt)
    tensors = [t for _, t in _trainable(pt)]
    rng = np.random.default_rng(7)
    for i in range(STEPS):
        if lr_scale is not None and i == 2:
            sj = jopt.set_lr_scale(sj, "unet_lora", lr_scale)
            assert topt.set_lr_scale(st, "unet_lora", lr_scale) is st
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), params)
        for t, (_, g) in zip(tensors, _trainable(grads)):
            t.grad = torch.from_numpy(g.copy())
        jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
        # the scale leaf is no trainable: zero gradient (JAX _zero_scale_grads)
        jgrads["unet_lora"]["a"]["scale"] = jnp.zeros(())
        upd, sj = tx.update(jgrads, sj, pj)
        pj = optax.apply_updates(pj, upd)
        pj["unet_lora"]["a"]["scale"] = jnp.asarray(params["unet_lora"]["a"]["scale"])
        updated = opt.step(st)
        assert bool(updated) == ((i + 1) % kw.get("grad_accum_steps", 1) == 0)
        for (path, got), (_, want) in zip(_trainable(pt), _trainable(pj)):
            _close(got.detach(), want, f"step {i} {path}")
        _check_moments(st, sj, kw.get("use_8bit", False),
                       0 if kw.get("max_grad_norm") is None else 0.002)
    assert int(st.count) == STEPS // kw.get("grad_accum_steps", 1)
    if "clip" in case:  # the gradients' norm is about 30: above the one max, below the other
        assert float(np.linalg.norm(np.concatenate(
            [g.ravel() for _, g in _trainable(grads)]))) > 10


def test_set_lr_scale_needs_the_runtime_scale():
    opt = topt.multi_group_optimizer({"unet_lora": topt.ParamGroup(lr=1e-3)})
    st = opt.init({"unet_lora": {"up": torch.zeros(2, 2, requires_grad=True)}})
    with pytest.raises(ValueError, match="runtime_lr_scale"):
        topt.set_lr_scale(st, "unet_lora", 0.5)


def test_apply_ti_constraints_takes_a_device_lr():
    """The TI renormalisation with its LR as a 0-d tensor equals it with
    the LR as a float (and JAX's)."""
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((12, 16)).astype(np.float32)
    orig = rng.standard_normal((12, 16)).astype(np.float32)
    upd = np.zeros(12, bool)
    upd[[2, 9]] = True
    args = [torch.from_numpy(a) for a in (emb, orig, upd)]
    want = jopt.apply_ti_constraints(jnp.asarray(emb), jnp.asarray(orig), jnp.asarray(upd), 4e-3)
    for lr in (4e-3, torch.tensor(4e-3), torch.tensor(0.5)):
        got = topt.apply_ti_constraints(*args, lr)
        if isinstance(lr, float) or float(lr) == pytest.approx(4e-3):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # min(1, 100 lr) saturates: the updated rows land on norm 0.4
    np.testing.assert_allclose(got[[2, 9]].norm(dim=-1).numpy(), 0.4, rtol=1e-5)
