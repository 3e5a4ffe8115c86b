"""Optimiser and LR schedules for LoRA / TI training (port of the JAX
``training/optim.py``).

* :func:`lr_schedule` -- the diffusers ``get_scheduler`` names (constant,
  constant_with_warmup, linear, cosine) with optax's formulas (JAX :24-82),
  evaluated on an int or on a 0-d count tensor;
* :class:`StepGate` -- a 0/1 LR gate on the step count (JAX :85-104);
* :class:`ParamGroup` -- one parameter group's AdamW settings, schedule and
  gate (JAX :108-161);
* :func:`multi_group_optimizer` -- one AdamW (or 8-bit AdamW) parameter
  group per named group, global-norm clipping, gradient accumulation and
  the runtime LR scale (JAX :225-278), with :func:`set_lr_scale` (:188);
* :func:`apply_ti_constraints` -- the TI embedding post-step treatment
  (JAX :365-388).

The update is capturable: it reads nothing on the host.  The count of
updates, the accumulation mini-step, each group's runtime LR scale and the
moments are device tensors; each group's LR is its schedule evaluated on
the count tensor.  A group's tensors are laid end to end in one flat fp32
buffer, each padded with zeros to whole 256-element blocks (the blocks of
JAX's per-leaf 8-bit quantisation), so that the clip, AdamW and the 8-bit
(de)quantisation run as a few kernels on flat buffers, not a few per tensor.

How it matches optax: AdamW is ``optax.adamw`` (decoupled decay on the
pre-update parameter, bias-corrected moments, eps outside the square root),
its schedule read at the count of updates made so far and its bias
correction at the count after this one; clipping computes
``where(norm < max, g, g / norm * max)`` as ``optax.clip_by_global_norm``
(no ``+1e-6`` as in ``clip_grad_norm_``); ``grad_accum_steps > 1`` keeps
optax.MultiSteps' running mean of the k gradients and makes one update on
the k-th.  That choice is made on the device: every call computes the
update and keeps it only on the k-th mini-step (``torch.where`` on a 0-d
boolean), so one captured step serves every mini-step, where a host
choice would need two graphs and a k-step graph one per phase.  The
runtime LR scale multiplies the LR; JAX scales the post-AdamW update,
the same thing under decoupled decay (:164-174).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Union

import torch

Count = Union[int, torch.Tensor]
Schedule = Callable[[Count], Union[float, torch.Tensor]]

BLOCK = 256  # adamw8bit's quantisation block (JAX :286)


def _clip(c, lo, hi):
    if isinstance(c, torch.Tensor):
        return torch.clamp(c.float(), lo, hi)
    return min(max(c, lo), hi)


def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else math.cos(x)


def _linear(init: float, end: float, steps: int) -> Schedule:
    # optax.linear_schedule
    return lambda c: (init - end) * (1.0 - _clip(c, 0, steps) / steps) + end


def _cosine(init: float, steps: int) -> Schedule:
    # optax.cosine_decay_schedule, alpha 0
    return lambda c: init * 0.5 * (1.0 + _cos(math.pi * _clip(c, 0, steps) / steps))


def _constant(value: float) -> Schedule:
    return lambda c: (torch.full((), value, dtype=torch.float32, device=c.device)
                      if isinstance(c, torch.Tensor) else value)


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    # optax.join_schedules
    def sched(c):
        if isinstance(c, torch.Tensor):
            return torch.where(c < boundary, first(c), then(c - boundary))
        return first(c) if c < boundary else then(c - boundary)
    return sched


def lr_schedule(name: str, learning_rate: float, num_warmup_steps: int = 0,
                num_training_steps: int = 10000) -> Schedule:
    """count -> learning rate, for the names the reference uses.  On an int
    it returns a float; on a 0-d count tensor a 0-d fp32 tensor on the same
    device, computed there (what a captured step needs)."""
    name = name.lower()
    warm = _linear(0.0, learning_rate, max(1, num_warmup_steps))
    decay_steps = max(1, num_training_steps - num_warmup_steps)
    if name == "constant":
        return _constant(learning_rate)
    if name == "constant_with_warmup":
        return _join(warm, _constant(learning_rate), num_warmup_steps)
    if name == "linear":
        return _join(warm, _linear(learning_rate, 0.0, decay_steps), num_warmup_steps)
    if name == "cosine":
        return _join(warm, _cosine(learning_rate, decay_steps), num_warmup_steps)
    raise ValueError(f"unknown lr schedule {name}")


@dataclasses.dataclass(frozen=True)
class StepGate:
    """0/1 LR gate on the step count: 1 when ``(count >= threshold) ==
    on_after`` -- the staged TI-then-LoRA schedule of the reference
    (train_lora_w_ti.py:988-994).  A float on an int, a 0-d fp32 tensor on a
    count tensor."""

    threshold: int
    on_after: bool = True

    def __call__(self, count: Count):
        cond = count >= self.threshold
        if not self.on_after:
            cond = ~cond if isinstance(cond, torch.Tensor) else not cond
        return cond.float() if isinstance(cond, torch.Tensor) else float(cond)


@dataclasses.dataclass
class ParamGroup:
    """One optimiser parameter group (reference per-group dict entries)."""

    lr: float
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 10000
    weight_decay: float = 1e-2
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    # the schedule is read at count * step_multiplier: the reference steps
    # its LR scheduler once per batch even under gradient accumulation
    step_multiplier: int = 1
    # multiplied onto the schedule (a StepGate: the staged TI-then-LoRA
    # gating of train_lora_w_ti.py:988-994)
    lr_gate: Optional[Callable[[Count], Any]] = None

    def cache_key(self):
        """Hashable identity tuple (raises TypeError for an opaque
        ``lr_gate`` callable, as JAX :131-141)."""
        gate = self.lr_gate
        if gate is not None and not isinstance(gate, StepGate):
            raise TypeError("opaque lr_gate callable is not cacheable")
        key = (self.lr, self.schedule, self.warmup_steps, self.total_steps,
               self.weight_decay, tuple(self.betas), self.eps, self.step_multiplier, gate)
        hash(key)
        return key

    def make(self) -> Schedule:
        """count -> this group's LR: the schedule times the gate, both read
        at ``count * step_multiplier``."""
        base = lr_schedule(self.schedule, self.lr, self.warmup_steps, self.total_steps)
        mult, gate = self.step_multiplier, self.lr_gate

        def sched(count):
            c = count * mult
            lr = base(c)
            return lr if gate is None else lr * gate(c)
        return sched


def trainable_tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a parameter tree that train, in a fixed order: every
    leaf except the LoRA ``scale`` leaves (runtime knobs, never trained)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for key in sorted(tree):
            if key != "scale" and tree[key] is not None:
                yield from trainable_tensors(tree[key])


class FlatLayout:
    """A group's tensors laid end to end in one flat fp32 vector, each
    padded with zeros to whole :data:`BLOCK`-element blocks, so a block
    never holds two tensors (JAX quantises each leaf on its own)."""

    def __init__(self, tensors: List[torch.Tensor]):
        self.shapes = [t.shape for t in tensors]
        sizes = [t.numel() for t in tensors]
        self.pads = [-n % BLOCK for n in sizes]
        self.split = [x for n, p in zip(sizes, self.pads) for x in (n, p)]
        self.numel = sum(self.split)

    def gather(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The tensors as one new flat fp32 vector (zeros in the padding)."""
        dev = tensors[0].device
        zeros = torch.zeros(max(self.pads), dtype=torch.float32, device=dev)
        return torch.cat([piece for t, p in zip(tensors, self.pads)
                          for piece in (t.reshape(-1).float(), zeros[:p])])

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of ``flat`` shaped like the tensors (padding left out)."""
        return [part.view(shape) for part, shape in zip(flat.split(self.split)[::2],
                                                        self.shapes)]


def quantize_blockwise(x: torch.Tensor):
    """fp32 vector of whole blocks -> (int8 (n, BLOCK), fp32 scales (n, 1)):
    the block's max |x| / 127 (1 where it is 0), ``round(x / scale)`` half
    to even, clipped to +-127 (JAX ``_quantize_blockwise``)."""
    blocks = x.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)


@dataclasses.dataclass
class OptimizerState:
    """What :class:`MultiGroupOptimizer` updates in place, all on the
    parameters' device: per group its parameters, its flat moments (``m``
    and ``v`` fp32, or with 8-bit moments ``m_q``/``v_q`` int8 blocks and
    ``m_s``/``v_s`` fp32 block scales, ``v`` stored as sqrt(v) as JAX does),
    its running gradient mean under accumulation and its runtime LR scale;
    the 0-d int64 count of updates made and of gradients accumulated toward
    the next one."""

    groups: Dict[str, List[torch.Tensor]]
    layouts: Dict[str, FlatLayout]
    moments: Dict[str, Dict[str, torch.Tensor]]
    count: torch.Tensor
    mini_step: torch.Tensor
    acc: Dict[str, torch.Tensor]
    lr_scale: Dict[str, torch.Tensor]

    def params(self) -> List[torch.Tensor]:
        return [p for ps in self.groups.values() for p in ps]

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state but the parameters, in a fixed order."""
        out = [self.count, self.mini_step]
        for name in sorted(self.groups):
            out += [self.moments[name][k] for k in sorted(self.moments[name])]
            out += [d[name] for d in (self.acc, self.lr_scale) if name in d]
        return out


@dataclasses.dataclass
class MultiGroupOptimizer:
    """AdamW (``use_8bit``: with int8 block-quantised moments) with one
    parameter group per name, global-norm clipping over all groups,
    optax.MultiSteps gradient accumulation and, with ``runtime_lr_scale``, a
    per-group LR scale set by :func:`set_lr_scale` without re-capturing."""

    groups: Dict[str, ParamGroup]
    grad_accum_steps: int = 1
    max_grad_norm: Optional[float] = None
    use_8bit: bool = False
    runtime_lr_scale: bool = False
    param_labels: Any = None

    def _labelled(self, params: Mapping[str, Any]) -> Dict[str, List[torch.Tensor]]:
        """{group name: its trainable tensors}, in the order of
        :func:`trainable_tensors` over ``params``.  ``param_labels`` (a
        label tree shaped like ``params``, or a callable mapping ``params``
        to one) names each leaf's group; None labels each top-level subtree
        with its own name."""
        labels = self.param_labels
        if labels is None:
            labels = {k: k for k in params}
        elif callable(labels):
            labels = labels(params)
        out: Dict[str, List[torch.Tensor]] = {}

        def walk(tree, label, path):
            if isinstance(label, Mapping):
                if isinstance(tree, torch.Tensor):
                    raise ValueError(f"param_labels has a subtree at {path} where the "
                                     "parameters have a tensor")
                for key in sorted(tree):
                    if key != "scale" and tree[key] is not None:
                        walk(tree[key], label[key], path + (key,))
                return
            for t in trainable_tensors(tree):
                if label not in self.groups:
                    raise ValueError(f"no ParamGroup for parameters {label!r} (at {path})")
                out.setdefault(label, []).append(t)

        walk({k: v for k, v in params.items() if v is not None}, labels, ())
        return dict(sorted(out.items()))

    def init(self, params: Mapping[str, Any]) -> OptimizerState:
        """``params``: {name: tree of tensors}; the trees' trainable tensors
        (fp32, requiring grad, on one device) are updated in place by
        :meth:`step`, each in the group ``param_labels`` gives it."""
        groups, layouts, moments, acc, scales = {}, {}, {}, {}, {}
        dev = None
        for name, tensors in self._labelled(params).items():
            groups[name] = tensors
            dev = tensors[0].device
            layout = layouts[name] = FlatLayout(tensors)
            zeros = torch.zeros(layout.numel, dtype=torch.float32, device=dev)
            if self.use_8bit:
                q, s = quantize_blockwise(zeros)
                moments[name] = {"m_q": q, "m_s": s, "v_q": q.clone(), "v_s": s.clone()}
            else:
                moments[name] = {"m": zeros, "v": zeros.clone()}
            if self.grad_accum_steps > 1:
                acc[name] = zeros.clone()
            if self.runtime_lr_scale:
                scales[name] = torch.ones((), dtype=torch.float32, device=dev)
        counter = lambda: torch.zeros((), dtype=torch.int64, device=dev)
        return OptimizerState(groups, layouts, moments, counter(), counter(), acc, scales)

    @torch.no_grad()
    def step(self, state: OptimizerState) -> torch.Tensor:
        """One optimiser step from the parameters' ``.grad`` (a missing grad
        counts as zero), in place and without reading the device.  Returns a
        0-d bool tensor: whether this call updated the parameters (always,
        unless accumulating towards the k-th gradient)."""
        grads = {name: state.layouts[name].gather(
            [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps])
            for name, ps in state.groups.items()}
        count = state.count
        k = self.grad_accum_steps
        if k > 1:
            n = state.mini_step + 1
            update = n == k
            for name, g in grads.items():
                a = state.acc[name]
                a.add_((g - a) / n)  # optax.MultiSteps' running mean
                grads[name] = a.clone()
                a.copy_(torch.where(update, 0.0, a))
            state.mini_step.copy_(torch.where(update, 0, n))
        else:
            update = torch.ones((), dtype=torch.bool, device=count.device)
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            grads = {name: torch.where(norm < self.max_grad_norm, g,
                                       g / norm * self.max_grad_norm)
                     for name, g in grads.items()}
        # the schedule at the count before this update, bias correction at
        # the one after
        bias_count = (count + 1).float()
        for name, ps in state.groups.items():
            group, layout = self.groups[name], state.layouts[name]
            lr = group.make()(count)
            if self.runtime_lr_scale:
                lr = lr * state.lr_scale[name]
            step = self._adamw8bit if self.use_8bit else self._adamw
            upd = step(group, state.moments[name], grads[name], layout.gather(ps), lr,
                       bias_count, update)
            torch._foreach_add_(ps, layout.views(torch.where(update, upd, 0.0)))
        count.add_(update.long())
        return update

    @staticmethod
    def _moments(group: ParamGroup, m, v, g):
        b1, b2 = group.betas
        return b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g

    @staticmethod
    def _update(group: ParamGroup, m, v, p, lr, bias_count):
        """optax.adamw's update of a flat vector: -lr (mhat / (sqrt(vhat) +
        eps) + wd p)."""
        b1, b2 = group.betas
        mhat = m / (1 - torch.pow(b1, bias_count))
        vhat = v / (1 - torch.pow(b2, bias_count))
        return -lr * (mhat / (torch.sqrt(vhat) + group.eps) + group.weight_decay * p)

    def _adamw(self, group, st, g, p, lr, bias_count, update):
        m, v = self._moments(group, st["m"], st["v"], g)
        upd = self._update(group, m, v, p, lr, bias_count)
        st["m"].copy_(torch.where(update, m, st["m"]))
        st["v"].copy_(torch.where(update, v, st["v"]))
        return upd

    def _adamw8bit(self, group, st, g, p, lr, bias_count, update):
        """JAX ``adamw8bit`` (:302-362): moments dequantised, updated in fp32
        and requantised per 256-element block, v in the sqrt domain."""
        m = dequantize_blockwise(st["m_q"], st["m_s"])
        v = dequantize_blockwise(st["v_q"], st["v_s"]) ** 2
        m, v = self._moments(group, m, v, g)
        upd = self._update(group, m, v, p, lr, bias_count)
        for (kq, ks), x in ((("m_q", "m_s"), m), (("v_q", "v_s"), torch.sqrt(v))):
            q, s = quantize_blockwise(x)
            st[kq].copy_(torch.where(update, q, st[kq]))
            st[ks].copy_(torch.where(update, s, st[ks]))
        return upd


def multi_group_optimizer(groups: Mapping[str, ParamGroup], param_labels: Any = None,
                          grad_accum_steps: int = 1, max_grad_norm: Optional[float] = None,
                          use_8bit: bool = False,
                          runtime_lr_scale: bool = False) -> MultiGroupOptimizer:
    """The reference's multi-LR optimiser (JAX :225-267).  ``param_labels``:
    a tree (or a callable mapping the parameter tree to one) labelling each
    leaf with a group name, as torch param-group dicts do; a label at an
    inner node labels every leaf under it, so one top-level subtree may be
    split over several groups.  None, what every trainer wants, trains each
    top-level subtree in the group of its own name."""
    return MultiGroupOptimizer(dict(groups), grad_accum_steps, max_grad_norm, use_8bit,
                               runtime_lr_scale, param_labels)


def set_lr_scale(opt_state: OptimizerState, group: str, value: float) -> OptimizerState:
    """Set a group's runtime LR scale (JAX :188) -- in place, on the device,
    so a captured step reads it on its next replay; returns the state.
    Needs ``multi_group_optimizer(..., runtime_lr_scale=True)``."""
    scale = opt_state.lr_scale.get(group)
    if scale is None:
        raise ValueError(
            f"no runtime lr_scale state for group {group!r} -- build the optimizer with "
            "multi_group_optimizer(..., runtime_lr_scale=True)")
    scale.fill_(value)
    return opt_state


@torch.no_grad()
def apply_ti_constraints(embeddings: torch.Tensor, orig_embeddings: torch.Tensor,
                         index_updates: torch.Tensor, lr: Union[float, torch.Tensor],
                         clip_ti_decay: bool = True, target_norm: float = 0.4) -> torch.Tensor:
    """Post-step TI embedding treatment: with ``clip_ti_decay`` the updated
    rows are renormalised to ``norm + min(1, 100 lr) (0.4 - norm)``; every
    frozen row is restored from ``orig_embeddings``.  ``lr`` may be a 0-d
    device tensor.  Returns a new tensor."""
    emb = embeddings
    rows = index_updates.to(emb.device).bool()[:, None]
    if clip_ti_decay:
        norms = emb.norm(dim=-1, keepdim=True)
        lam = (torch.clamp(100.0 * lr, max=1.0) if isinstance(lr, torch.Tensor)
               else min(1.0, 100.0 * lr))
        safe = torch.where(norms == 0, torch.ones_like(norms), norms)
        renormed = emb / safe * (norms + lam * (target_norm - norms))
        emb = torch.where(rows, renormed, emb)
    return torch.where(rows, emb, orig_embeddings.to(emb.device, emb.dtype))
