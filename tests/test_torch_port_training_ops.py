"""The port's training ops against the JAX package, on the CPU.

Flash-attention backward, the autograd of flash attention and of the LoRA
dense, the DDPM scheduler, the LR schedules, the TI constraints and the
multi-group optimiser.  The JAX Pallas kernels run in interpret mode, as
tests/test_flash_attention.py runs them; the port's wrappers run their plain
versions on CPU tensors.  Inputs are made with numpy from a seed and handed
to both.

Tolerances: fp32 1e-5 (the same sums in another order); bf16 flash backward
within 2e-2 of the largest reference value, with the mean error 10x tighter
(both sides round P and dS to bf16 at the same places, from fp32 sums taken
in another order, so single values may land a bf16 ulp apart); LR schedules
1e-6 of the peak LR (optax computes them in fp32, the port in float64: near
the end of a decay, 1 - c / n cancels to a few fp32 ulps); the
optimiser 1e-6 on parameters that move by ~1e-3 a step (AdamW's update
written in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from diffusion_finetuning_tpu.models import schedulers as jsched
from diffusion_finetuning_tpu.ops import flash_attention as jfa
from diffusion_finetuning_tpu.ops.lora_matmul import lora_dense as jax_lora_dense
from diffusion_finetuning_tpu.training import optim as jopt

from diffusion_finetuning_tpu_torch.models import schedulers as tsched
from diffusion_finetuning_tpu_torch.ops import flash_attention as tfa
from diffusion_finetuning_tpu_torch.ops import lora_matmul as tlm
from diffusion_finetuning_tpu_torch.training import optim as topt

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        peak = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=2e-2 * peak, rtol=0)
        assert np.abs(got - want).mean() < 2e-3 * peak


def _check_plain_bwd_against_jax(d, sq, skv, dtype, q_splits=1):
    """dQ, dK, dV of flash_backward_plain (``q_splits`` dK/dV partials)
    against JAX _bwd (interpret, exp2), from JAX's own O and base-2 lse;
    ragged Sq and Skv are zero rows of q/dO and masked columns on the JAX
    side."""
    rng = np.random.default_rng(0)
    q, do = (rng.standard_normal((2, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, skv, d)).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    blk = 128
    sq_p, skv_p = -(-sq // blk) * blk, -(-skv // blk) * blk

    def pad(a, s_p):
        return jnp.asarray(np.pad(a, ((0, 0), (0, s_p - a.shape[1]), (0, 0))), _JAX[dtype])

    qp, kp, vp, dop = pad(q, sq_p), pad(k, skv_p), pad(v, skv_p), pad(do, sq_p)
    o_j, lse_j = jfa._fwd(qp, kp, vp, scale, skv, blk, blk, True, exp2=True)
    dq_j, dk_j, dv_j = jfa._bwd(qp, kp, vp, o_j, lse_j, dop, scale, skv, blk, blk, True,
                                exp2=True)

    tt = lambda a: torch.from_numpy(np.array(a, np.float32)).to(_TORCH[dtype])
    o_t = tt(np.asarray(o_j.astype(jnp.float32))[:, :sq])
    lse_t = torch.from_numpy(np.array(lse_j[:, 0, :sq]))
    got = tfa.flash_backward_plain(tt(q), tt(k), tt(v), o_t, lse_t, tt(do), scale,
                                   q_splits=q_splits)
    for g, w, n in zip(got, (dq_j[:, :sq], dk_j[:, :skv], dv_j[:, :skv]), (sq, skv, skv)):
        assert g.dtype == _TORCH[dtype] and g.shape == (2, n, d)
        _close(g.float().numpy(), np.asarray(w.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,sq,skv", [(40, 96, 77), (80, 50, 130), (160, 40, 77)])
def test_flash_backward_plain_matches_jax_bwd(d, sq, skv, dtype):
    _check_plain_bwd_against_jax(d, sq, skv, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,sq,q_splits", [(40, 150, 3), (160, 70, 5)])
def test_flash_backward_plain_q_splits_matches_jax_bwd(d, sq, q_splits, dtype):
    """The plain version of K3's split q loop: dK and dV summed from fp32
    partials over the kernel's q-split ranges (ragged Sq, Skv = 77) in split
    order, against JAX _bwd in interpret mode, with the tolerance above."""
    rows = tfa.bwd_split_rows(sq, d, q_splits)
    assert len(rows) == q_splits and rows[-1][1] == sq and rows[-1][0] % tfa.bwd_q_rows(d) == 0
    _check_plain_bwd_against_jax(d, sq, 77, dtype, q_splits)


@pytest.mark.parametrize("sq,skv,heads,d", [(64, 64, 2, 40), (100, 77, 2, 80)])
def test_flash_attention_grad_matches_jax(sq, skv, heads, d):
    """Autograd through the port's (B, S, H*D) flash_attention (split,
    FlashAttentionFunction, merge) against jax.grad of JAX flash_attention."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, s, heads * d)).astype(np.float32)
               for s in (sq, skv, skv))
    dout = rng.standard_normal((2, sq, heads * d)).astype(np.float32)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, heads, interpret=True, block_q=128, block_kv=128)
        return jnp.sum(out * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, heads)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


class _MatmulShapes(TorchDispatchMode):
    """Records the output shape of every 2-D matrix product."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.mm.default:
            self.shapes.append(tuple(out.shape))
        return out


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_lora_dense_grad_matches_jax(bias):
    """Gradients for x, up, down (and bias) of the port's lora_dense against
    jax.grad of JAX lora_dense (interpret); the frozen weight gets no dW."""
    rng = np.random.default_rng(3)
    m, kdim, n, r = 37, 24, 50, 4
    x = rng.standard_normal((m, kdim)).astype(np.float32)
    w = (rng.standard_normal((n, kdim)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((n,)) * 0.1).astype(np.float32)
    up = (rng.standard_normal((n, r)) * 0.3).astype(np.float32)
    down = (rng.standard_normal((r, kdim)) * 0.3).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)

    def jloss(x, up, down, b):
        y = jax_lora_dense(x, jnp.asarray(w.T), b if bias else None, up, down,
                           jnp.asarray(0.75, jnp.float32), interpret=True)
        return jnp.sum(y * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, up, down, b)))
    xt, upt, downt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, up, down, b))
    wt = torch.from_numpy(w)
    y = tlm.lora_dense(xt, wt, bt if bias else None, upt, downt, torch.tensor(0.75))
    with _MatmulShapes() as seen:
        y.backward(torch.from_numpy(g))
    assert (n, kdim) not in seen.shapes and wt.grad is None
    names = ("x", "up", "down", "bias") if bias else ("x", "up", "down")
    for name, t, wnt in zip(names, (xt, upt, downt, bt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    # with a weight that trains, exactly one product has dW's shape
    wt.requires_grad_(True)
    y = tlm.lora_dense(xt, wt, None, upt, downt, torch.tensor(0.75))
    with _MatmulShapes() as seen:
        y.backward(torch.from_numpy(g))
    assert seen.shapes.count((n, kdim)) == 1 and wt.grad.shape == (n, kdim)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddpm_matches_jax(prediction_type):
    """add_noise, get_velocity, training_target and the ancestral step (with
    JAX's own noise handed over) at t = 0, 1, 500, 999."""
    js = jsched.DDPMScheduler(jsched.SchedulerConfig(prediction_type=prediction_type))
    ts = tsched.DDPMScheduler(tsched.SchedulerConfig(prediction_type=prediction_type))
    rng = np.random.default_rng(4)
    x0, noise, out = (rng.standard_normal((4, 8, 8, 4)).astype(np.float32) for _ in range(3))
    t = np.array([0, 1, 500, 999], np.int32)
    tt = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    back = lambda a: a.permute(0, 2, 3, 1).numpy()
    for name in ("add_noise", "get_velocity", "training_target"):
        want = getattr(js, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        got = getattr(ts, name)(tt(x0), tt(noise), torch.from_numpy(t))
        np.testing.assert_allclose(back(got), np.asarray(want), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    for i, step_t in enumerate(t):
        key = jax.random.PRNGKey(i)
        want = js.step(jnp.asarray(out), jnp.asarray(step_t), jnp.asarray(x0), key)
        jax_noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
        got = ts.step(tt(out), int(step_t), tt(x0), noise=tt(jax_noise))
        np.testing.assert_allclose(back(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    # drawn noise: a seeded generator is reproducible and moves the sample
    a = ts.step(tt(out), 500, tt(x0), generator=torch.Generator().manual_seed(0))
    b = ts.step(tt(out), 500, tt(x0), generator=torch.Generator().manual_seed(0))
    mean = ts.step(tt(out), 500, tt(x0), noise=torch.zeros(4, 4, 8, 8))
    assert torch.equal(a, b) and float((a - mean).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedule_matches_jax(name):
    want = jopt.lr_schedule(name, 3e-4, num_warmup_steps=10, num_training_steps=100)
    got = topt.lr_schedule(name, 3e-4, num_warmup_steps=10, num_training_steps=100)
    counts = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(want(jnp.asarray(c))) for c in counts],
                               rtol=1e-6, atol=1e-6 * 3e-4)


@pytest.mark.parametrize("clip_ti_decay", [True, False])
def test_apply_ti_constraints_matches_jax(clip_ti_decay):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((12, 16)).astype(np.float32)
    emb[3] = 0.0  # a zero row keeps its norm of 0
    orig = rng.standard_normal((12, 16)).astype(np.float32)
    upd = np.zeros(12, bool)
    upd[[2, 3, 9]] = True
    want = jopt.apply_ti_constraints(jnp.asarray(emb), jnp.asarray(orig), jnp.asarray(upd),
                                     4e-3, clip_ti_decay=clip_ti_decay)
    got = topt.apply_ti_constraints(torch.from_numpy(emb), torch.from_numpy(orig),
                                    torch.from_numpy(upd), 4e-3, clip_ti_decay=clip_ti_decay)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_multi_group_optimizer_matches_optax(accum):
    """Two groups (different LR, decay and schedule), global-norm clipping
    that triggers, and optax.MultiSteps accumulation: the parameters after
    each of 4 gradient steps, against the JAX optimiser."""
    rng = np.random.default_rng(6)
    groups_j = {"unet_lora": jopt.ParamGroup(lr=1e-3, schedule="cosine", warmup_steps=1,
                                             total_steps=6),
                "ti_embeddings": jopt.ParamGroup(lr=5e-3, weight_decay=0.0)}
    groups_t = {"unet_lora": topt.ParamGroup(lr=1e-3, schedule="cosine", warmup_steps=1,
                                             total_steps=6),
                "ti_embeddings": topt.ParamGroup(lr=5e-3, weight_decay=0.0)}
    params = {"unet_lora": {"a": {"up": rng.standard_normal((6, 2)).astype(np.float32),
                                  "down": rng.standard_normal((2, 5)).astype(np.float32)}},
              "ti_embeddings": rng.standard_normal((7, 3)).astype(np.float32)}
    tx = jopt.multi_group_optimizer(groups_j, grad_accum_steps=accum, max_grad_norm=0.5)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    sj = tx.init(pj)
    opt = topt.multi_group_optimizer(groups_t, grad_accum_steps=accum, max_grad_norm=0.5)
    pt = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
    st = opt.init(pt)
    tensors = list(topt.trainable_tensors(pt))
    for _ in range(4):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        upd, sj = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), sj, pj)
        pj = optax.apply_updates(pj, upd)
        for t, g in zip(tensors, topt.trainable_tensors(
                jax.tree_util.tree_map(torch.from_numpy, grads))):
            t.grad = g.clone()
        opt.step(st)
        for t, w in zip(tensors, topt.trainable_tensors(
                jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)), pj))):
            np.testing.assert_allclose(t.detach().numpy(), w.numpy(), atol=1e-6, rtol=1e-6)
    assert st.count == 4 // accum
