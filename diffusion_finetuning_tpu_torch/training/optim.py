"""Optimiser and LR schedules for LoRA / TI training (port of the JAX
``training/optim.py`` subset on the training path).

* :func:`lr_schedule` -- the diffusers ``get_scheduler`` names (constant,
  constant_with_warmup, linear, cosine) with optax's formulas (JAX :24-82);
* :class:`ParamGroup` -- one parameter group's AdamW settings and schedule
  (JAX :108-161);
* :func:`multi_group_optimizer` -- one AdamW parameter group per named
  group, global-norm clipping and gradient accumulation (JAX :225-278);
* :func:`apply_ti_constraints` -- the TI embedding post-step treatment
  (JAX :365-388).

How it matches optax: ``torch.optim.AdamW`` computes ``optax.adamw``'s update
(decoupled decay on the pre-update parameter, bias-corrected moments, eps
outside the square root); the schedule is read at the count of updates made
so far (optax reads it before incrementing); clipping multiplies by
max_norm / norm only when norm >= max_norm, as ``optax.clip_by_global_norm``
(no ``+1e-6`` as in ``clip_grad_norm_``); ``grad_accum_steps > 1`` keeps
optax.MultiSteps' running mean of the k gradients and makes one update on
the k-th.  The 8-bit AdamW, ``StepGate`` (with ``ParamGroup.lr_gate``) and
the runtime LR scale come later.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    return lambda c: (init - end) * (1.0 - min(max(c, 0), steps) / steps) + end


def _cosine(init: float, steps: int) -> Schedule:
    return lambda c: init * 0.5 * (1.0 + math.cos(math.pi * min(c, steps) / steps))


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    return lambda c: first(c) if c < boundary else then(c - boundary)


def lr_schedule(name: str, learning_rate: float, num_warmup_steps: int = 0,
                num_training_steps: int = 10000) -> Schedule:
    """count -> learning rate, for the names the reference uses."""
    name = name.lower()
    warm = _linear(0.0, learning_rate, max(1, num_warmup_steps))
    decay_steps = max(1, num_training_steps - num_warmup_steps)
    if name == "constant":
        return lambda c: learning_rate
    if name == "constant_with_warmup":
        return _join(warm, lambda c: learning_rate, num_warmup_steps)
    if name == "linear":
        return _join(warm, _linear(learning_rate, 0.0, decay_steps), num_warmup_steps)
    if name == "cosine":
        return _join(warm, _cosine(learning_rate, decay_steps), num_warmup_steps)
    raise ValueError(f"unknown lr schedule {name}")


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

    def make(self) -> Schedule:
        base = lr_schedule(self.schedule, self.lr, self.warmup_steps, self.total_steps)
        return lambda count: base(count * self.step_multiplier)


def trainable_tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a parameter tree that train, in a fixed order: every
    leaf except the LoRA ``scale`` leaves (runtime knobs, never trained)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for key in sorted(tree):
            if key != "scale" and tree[key] is not None:
                yield from trainable_tensors(tree[key])


@dataclasses.dataclass
class OptimizerState:
    """The state :class:`MultiGroupOptimizer` updates in place: the AdamW of
    the groups, the count of updates made, and the gradient accumulator."""

    groups: Dict[str, List[torch.Tensor]]
    adamw: torch.optim.AdamW
    count: int = 0
    mini_step: int = 0
    acc: Optional[List[torch.Tensor]] = None

    def params(self) -> List[torch.Tensor]:
        return [p for ps in self.groups.values() for p in ps]


@dataclasses.dataclass
class MultiGroupOptimizer:
    """AdamW with one parameter group per name, global-norm clipping over
    all groups, and optax.MultiSteps gradient accumulation."""

    groups: Dict[str, ParamGroup]
    grad_accum_steps: int = 1
    max_grad_norm: Optional[float] = None

    def init(self, params: Mapping[str, Any]) -> OptimizerState:
        """``params``: {group name: tree of tensors}; the trees' trainable
        tensors (fp32, requiring grad) are updated in place by :meth:`step`."""
        groups, torch_groups = {}, []
        for name, tree in sorted(params.items()):
            if tree is None:
                continue
            if name not in self.groups:
                raise ValueError(f"no ParamGroup for parameters {name!r}")
            g = self.groups[name]
            groups[name] = list(trainable_tensors(tree))
            torch_groups.append(dict(params=groups[name], lr=0.0, betas=tuple(g.betas),
                                     eps=g.eps, weight_decay=g.weight_decay, name=name))
        return OptimizerState(groups, torch.optim.AdamW(torch_groups))

    def step(self, state: OptimizerState) -> bool:
        """One optimiser step from the parameters' ``.grad`` (missing grads
        count as zero).  Returns whether the parameters were updated (always,
        unless accumulating towards the k-th step)."""
        params = state.params()
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
                 for p in params]
        k = self.grad_accum_steps
        if k > 1:
            if state.acc is None:
                state.acc = [torch.zeros_like(g) for g in grads]
            n = state.mini_step
            for a, g in zip(state.acc, grads):
                a.add_((g - a) / (n + 1))  # optax.MultiSteps' running mean
            if n + 1 < k:
                state.mini_step = n + 1
                return False
            grads, state.acc, state.mini_step = state.acc, None, 0
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            grads = [torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm)
                     for g in grads]
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype)
        for group in state.adamw.param_groups:
            group["lr"] = self.groups[group["name"]].make()(state.count)
        state.adamw.step()
        state.count += 1
        return True


def multi_group_optimizer(groups: Mapping[str, ParamGroup], grad_accum_steps: int = 1,
                          max_grad_norm: Optional[float] = None) -> MultiGroupOptimizer:
    """The reference's multi-LR optimiser: each top-level subtree of the
    parameters trains in the group of its own name."""
    return MultiGroupOptimizer(dict(groups), grad_accum_steps, max_grad_norm)


@torch.no_grad()
def apply_ti_constraints(embeddings: torch.Tensor, orig_embeddings: torch.Tensor,
                         index_updates: torch.Tensor, lr: float, clip_ti_decay: bool = True,
                         target_norm: float = 0.4) -> torch.Tensor:
    """Post-step TI embedding treatment: with ``clip_ti_decay`` the updated
    rows are renormalised to ``norm + min(1, 100 lr) (0.4 - norm)``; every
    frozen row is restored from ``orig_embeddings``.  Returns a new tensor."""
    emb = embeddings
    rows = index_updates.to(emb.device).bool()[:, None]
    if clip_ti_decay:
        norms = emb.norm(dim=-1, keepdim=True)
        lam = min(1.0, 100.0 * lr)
        safe = torch.where(norms == 0, torch.ones_like(norms), norms)
        renormed = emb / safe * (norms + lam * (target_norm - norms))
        emb = torch.where(rows, renormed, emb)
    return torch.where(rows, emb, orig_embeddings.to(emb.device, emb.dtype))
