"""The train step and its compiled dispatch (port of the JAX
``training/train_step.py``).

:func:`build_train_step` returns ``step(state, batch, generator=None,
draws=None) -> (state, metrics)``: the gradients of ``loss_step`` w.r.t. the
trainable tensors, the multi-group AdamW update, then the TI embedding
constraints, as the JAX step (``jax.value_and_grad`` + ``optimizer.update``).
It runs eagerly: on the card every UNet attention call runs the
flash-attention kernels (K1 or K4 forward, K3 backward) and every LoRA'd
projection the fused LoRA kernel (K2) forward.

The state is a dict, built by :func:`init_train_state`:

* ``params``: ``{"unet_lora": tree | None, "text_lora": tree | None,
  "ti_embeddings": (vocab, dim) | None}`` -- fp32 master tensors on the
  device that require grad; the LoRA ``scale`` leaves are plain fp32 tensors
  that never train (JAX ``_zero_scale_grads`` / ``_restore_scale_leaves``:
  they enter neither the clip norm nor AdamW's decay);
* ``static``: ``{"orig_embeddings", "index_updates"}`` for TI;
* ``opt_state``: the :class:`~.optim.OptimizerState`;
* ``step``: the number of batches seen, a host int as in the JAX contract;
* ``device_step``: the same count as a 0-d int64 device tensor, which the
  step reads (the TI LR and the accumulation boundary) and advances.

Unlike the JAX step, which is pure, this one UPDATES ``state`` IN PLACE and
returns the same dict; gradients are zeroed in place, never dropped, and the
step reads nothing on the host, so that it can be captured.

The compiled dispatch of the JAX package (:274-612) is a CUDA-graph capture
here (``graph.py``): :func:`jit_train_step` captures one step,
:func:`multi_step` k steps into one graph fed ``(k, ...)``-stacked batches,
and :class:`FusedDispatcher` drives a trainer's loop with them.  Each
captures on the first call of a key and replays after that; a graph's
random draws are made before the replay from the caller's generator, in the
order the eager step makes them, and copied into static buffers, so a
replay gives the eager step's result.  On the CPU they run the step eagerly.

With a mesh (``parallel.mesh``, JAX's ``mesh=``) each rank steps on its rows
of the node's batch and the gradients are summed over the mesh inside the
step (:func:`reduce_gradients`, one all-reduce of a flat buffer); under
NCCL that all-reduce is captured in the graph, under gloo the step runs
eagerly (``cuda_graphs=False``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, List, Mapping, Optional

import numpy as np
import torch

from .. import resolve_device
from ..graph import Graphs
from ..lora import module_name
from ..models.layers import kernel_switches
from ..parallel import mesh as mesh_lib
from ..utils import profiling
from .loss import RowShard, draw_inputs, loss_step
from .optim import MultiGroupOptimizer, apply_ti_constraints, trainable_tensors


@dataclasses.dataclass
class TrainablePartition:
    """What trains in a phase (JAX :56-71): the UNet and/or text LoRA trees,
    and with ``ti`` the token-embedding matrix; ``ti_constrained`` applies
    the inversion-phase treatment (frozen rows masked, norm decay)."""

    unet_lora: bool = True
    text_lora: bool = False
    ti: bool = False
    ti_constrained: bool = True


def master_tree(tree: Optional[Mapping[str, Any]], device) -> Optional[Dict[str, Any]]:
    """fp32 copies of a LoRA tree on ``device``: up/down require grad, the
    ``scale`` leaves do not."""
    if tree is None:
        return None
    out = {}
    for key, node in tree.items():
        if isinstance(node, Mapping):
            out[key] = master_tree(node, device)
        else:
            t = torch.as_tensor(node).detach().to(device, torch.float32).clone()
            out[key] = t if key == "scale" else t.requires_grad_(True)
    return out


def init_train_state(optimizer: MultiGroupOptimizer, *, unet_lora=None, text_lora=None,
                     ti_embeddings=None, index_updates=None, device="cuda") -> Dict[str, Any]:
    """The train state on ``device`` (the card unless the caller asks for
    the CPU): fp32 masters of the given trees and embeddings, the
    optimiser's state over them, step 0."""
    dev = resolve_device(device)
    emb = None
    static: Dict[str, Any] = {}
    if ti_embeddings is not None:
        orig = torch.as_tensor(ti_embeddings).detach().to(dev, torch.float32).clone()
        emb = orig.clone().requires_grad_(True)
        upd = (torch.zeros(orig.shape[0], dtype=torch.bool) if index_updates is None
               else torch.as_tensor(index_updates))
        static = {"orig_embeddings": orig, "index_updates": upd.to(dev, torch.bool)}
    params = {"unet_lora": master_tree(unet_lora, dev), "text_lora": master_tree(text_lora, dev),
              "ti_embeddings": emb}
    return {"params": params, "static": static,
            "opt_state": optimizer.init({k: v for k, v in params.items() if v is not None}),
            "step": 0, "device_step": torch.zeros((), dtype=torch.int64, device=dev)}


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for key in sorted(tree) if tree[key] is not None for t in _leaves(tree[key])]
    return []


def carried_tensors(state: Mapping[str, Any]) -> List[torch.Tensor]:
    """The tensors a step updates, in a fixed order: every parameter leaf
    (the ``scale`` leaves too), the optimiser state's tensors and the device
    step."""
    return _leaves(state["params"]) + state["opt_state"].tensors() + [state["device_step"]]


def _row_shard(mesh, batch) -> RowShard:
    b = len(batch["input_ids"])
    lo, total = mesh_lib.batch_rows(mesh, b)
    return RowShard(lo, total, lambda m: mesh_lib.gather_node_batch(m, mesh))


def _split_flags(params: Mapping[str, Any], models: Mapping[str, Any]) -> List[bool]:
    """For each tensor of :func:`trainable_tensors` over ``params``: whether
    it is a LoRA leaf of a tensor-parallel layer (``parallel/tp.py``), whose
    gradient on a rank is a zero-padded partial."""
    flags: List[bool] = []

    def walk(tree, model, path):
        if isinstance(tree, torch.Tensor):
            split = False
            if model is not None and getattr(model, "_dft_tp_mesh", None) is not None:
                name = module_name(path[:-1], getattr(model, "lora_prefix", ""))
                split = hasattr(model.get_submodule(name), "_dft_tp")
            flags.append(split)
        elif isinstance(tree, Mapping):
            for key in sorted(tree):
                if key != "scale" and tree[key] is not None:
                    walk(tree[key], model, path + (key,))

    for key in sorted(params):
        if params[key] is not None:
            walk(params[key], models.get(key), ())
    return flags


def reduce_gradients(params: Mapping[str, Any], loss: torch.Tensor, mesh,
                     split: List[bool]) -> torch.Tensor:
    """Sum the trainable tensors' gradients and the loss shares over the
    mesh, in place, with one all-reduce of a flat buffer (the trainable set
    is LoRA and TI rows, small).  Over ``data`` the ranks' gradients of
    their loss shares add up to the global gradient; over ``tp`` a split
    layer's leaf (``split``) adds its zero-padded partials, and every other
    leaf, the same on each ``tp`` rank, is counted once, from ``tp`` rank 0,
    as is the loss.  Returns the global loss."""
    tensors = list(trainable_tensors(params))
    keep = mesh.index("tp") == 0
    parts = [t.grad.reshape(-1) if t.grad is not None and (s or keep)
             else torch.zeros(t.numel(), dtype=t.dtype, device=t.device)
             for t, s in zip(tensors, split)]
    share = loss.detach().float().reshape(1)
    flat = torch.cat(parts + [share if keep else torch.zeros_like(share)])
    mesh_lib.all_reduce(flat, mesh.group)
    for t, g in zip(tensors, flat[:-1].split([t.numel() for t in tensors])):
        if t.grad is None:
            t.grad = g.view_as(t).clone()
        else:
            t.grad.copy_(g.view_as(t))
    return flat[-1]


def build_train_step(*, unet, text_encoder, vae, scheduler, optimizer: MultiGroupOptimizer,
                     partition: TrainablePartition, t_mutliplier: float = 1.0,
                     with_prior_preservation: bool = False, prior_loss_weight: float = 1.0,
                     clip_ti_decay: bool = True, ti_lr_schedule: Optional[Callable] = None,
                     grad_accum_steps: int = 1) -> Callable:
    """``step(state, batch, generator=None, draws=None, mesh=None) -> (state,
    metrics)``; ``metrics["loss"]`` is a 0-d tensor on the device (reading
    it syncs).  ``draws`` hands ``loss_step`` its random draws;
    ``step.draws(batch, generator, mesh=None)`` makes the ones a call with
    ``generator`` would make.  ``ti_lr_schedule`` is called on the 0-d
    device step count.

    With ``mesh`` (``parallel.mesh``; bound by :func:`jit_train_step` and
    :class:`FusedDispatcher`) ``batch`` is this rank's rows of the global
    batch: the loss is the rank's share of the global loss (the global
    batch's draws, global denominators; ``training/loss.py``), and between
    ``backward`` and the update the gradients are summed over the mesh
    (:func:`reduce_gradients`), before the TI row mask and the clip, in a
    fixed order.  ``metrics["loss"]`` is then the global loss."""
    if unet.config.text_time:
        raise ValueError("the trainers do not give the UNet SDXL's text-time conditioning "
                         "yet: an SDXL UNet cannot be trained")
    if partition.ti and partition.ti_constrained and clip_ti_decay and ti_lr_schedule is None:
        raise ValueError(
            "clip_ti_decay needs ti_lr_schedule (lambda = min(1, 100*lr)); "
            "without it the norm decay would silently be a no-op")
    partition = dataclasses.replace(partition)
    constrained = partition.ti and partition.ti_constrained

    def step(state, batch, generator: Optional[torch.Generator] = None, draws=None,
             mesh=None):
        params = state["params"]
        grads = [t.grad for t in trainable_tensors(params) if t.grad is not None]
        if grads:
            torch._foreach_zero_(grads)
        loss = loss_step(
            batch, unet=unet, text_encoder=text_encoder, vae=vae, scheduler=scheduler,
            unet_lora=params.get("unet_lora"), text_lora=params.get("text_lora"),
            token_embedding=params["ti_embeddings"] if partition.ti else None,
            t_mutliplier=t_mutliplier, with_prior_preservation=with_prior_preservation,
            prior_loss_weight=prior_loss_weight, generator=generator, draws=draws,
            shard=None if mesh is None else _row_shard(mesh, batch))
        loss.backward()
        if mesh is not None:
            loss = reduce_gradients(params, loss, mesh, _split_flags(
                params, {"unet_lora": unet, "text_lora": text_encoder}))
        emb = params["ti_embeddings"]
        if constrained and emb.grad is not None:
            # frozen vocab rows get zero gradient (JAX :171-178)
            emb.grad.masked_fill_(~state["static"]["index_updates"][:, None], 0.0)
        optimizer.step(state["opt_state"])
        count = state["device_step"]
        if constrained:
            lr = ti_lr_schedule(count) if ti_lr_schedule is not None else 0.0
            with torch.no_grad():
                new = apply_ti_constraints(emb, state["static"]["orig_embeddings"],
                                           state["static"]["index_updates"], lr,
                                           clip_ti_decay=clip_ti_decay)
                if grad_accum_steps > 1:
                    # renormalise / restore on accumulation boundaries only
                    # (JAX :188-207)
                    new = torch.where((count + 1) % grad_accum_steps == 0, new, emb)
                emb.copy_(new)
        count.add_(1)
        state["step"] += 1
        return state, {"loss": loss.detach()}

    step.draws = lambda batch, generator=None, mesh=None: draw_inputs(
        batch, vae=vae, scheduler=scheduler, t_mutliplier=t_mutliplier, generator=generator,
        shard=None if mesh is None else _row_shard(mesh, batch))
    step.device = next(unet.parameters()).device
    return step


# ---------------------------------------------------------------------------
# compiled dispatch: CUDA graphs of one step or k steps
# ---------------------------------------------------------------------------


def _per_fn_cache(fn: Callable, attr: str) -> dict:
    """A memo dict stored on the function object (JAX :222-246): the cache
    and the function then form one cycle that the garbage collector frees
    with the function."""
    cache = fn.__dict__.get(attr)
    if cache is None:
        cache = {}
        setattr(fn, attr, cache)
    return cache


def _graphs(step_fn: Callable, device: torch.device) -> Graphs:
    """The graphs of ``step_fn`` on ``device``: jit_train_step's,
    multi_step's and a FusedDispatcher's share one capture stream and one
    memory pool."""
    cache = _per_fn_cache(step_fn, "_dft_graphs")
    if device not in cache:
        cache[device] = Graphs(device)
    return cache[device]


def _index(tree: Optional[Mapping[str, Any]], i: int):
    return None if tree is None else {k: None if v is None else v[i] for k, v in tree.items()}


def stack_batches(batches, mesh=None):
    """Stack a list of host batches along a new leading axis (the input of
    :func:`multi_step`): numpy arrays with numpy, tensors with torch.  With
    ``mesh``, each batch's rows of this rank (``parallel.mesh.local_rows``)."""
    if mesh is not None:
        batches = [mesh_lib.local_rows(b, mesh) for b in batches]
    first = batches[0]
    return {k: None if first[k] is None else
            (torch.stack([b[k] for b in batches]) if isinstance(first[k], torch.Tensor)
             else np.stack([b[k] for b in batches]))
            for k in first}


def _signature(tree) -> tuple:
    return tuple(sorted((k, None if v is None else (tuple(v.shape),
                                                     str(torch.as_tensor(v).dtype)))
                        for k, v in (tree or {}).items()))


class _Steps:
    """``k`` calls of ``step_fn`` on batch (and draws) i of ``(k, ...)``-
    stacked inputs (``stacked``) or on one batch, with fp32 state rounded to
    ``carry_dtype`` before each step and after the last (JAX's hoisted scan
    carry, :308-321).  On the card: one CUDA graph per batch layout and
    state, captured on first use, replayed after (``cuda_graphs`` off:
    eagerly).  ``mesh`` is passed to the step; a gloo mesh's collectives
    cannot be captured, so it needs ``cuda_graphs=False`` on the card."""

    def __init__(self, step_fn: Callable, k: int, carry_dtype, stacked: bool, mesh=None,
                 cuda_graphs: bool = True):
        if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {type(mesh).__name__}")
        self.step_fn, self.k, self.carry_dtype, self.stacked = step_fn, k, carry_dtype, stacked
        self.mesh, self.cuda_graphs = mesh, cuda_graphs
        self._kw = {} if mesh is None else {"mesh": mesh}

    def local(self, batches):
        """This rank's rows of node batches (stacked: along axis 1)."""
        if self.mesh is None:
            return batches
        return mesh_lib.local_rows(batches, self.mesh, 1 if self.stacked else 0)

    def _eager(self, state, batches, generator, draws) -> torch.Tensor:
        floats = ([t for t in carried_tensors(state) if t.dtype == torch.float32]
                  if self.carry_dtype is not None else [])

        def carry():
            with torch.no_grad():
                for t in floats:
                    t.copy_(t.to(self.carry_dtype))

        losses = []
        for i in range(self.k):
            carry()
            batch, d = ((_index(batches, i), _index(draws, i)) if self.stacked
                        else (batches, draws))
            state, m = self.step_fn(state, batch, generator, draws=d, **self._kw)
            losses.append(m["loss"])
        carry()
        return torch.stack(losses) if self.stacked else losses[0]

    def _draws(self, batches, generator):
        """The draws of the k steps, made now in the eager steps' order."""
        make = getattr(self.step_fn, "draws", None)
        if make is None:
            raise ValueError("a captured step needs its draws: pass draws=, or a step "
                             "function with a draws(batch, generator) method")
        if not self.stacked:
            return make(batches, generator, **self._kw)
        per_step = [make(_index(batches, i), generator, **self._kw) for i in range(self.k)]
        return {key: torch.stack([d[key] for d in per_step]) for key in per_step[0]}

    def _key(self, state, batches, draws) -> Hashable:
        with profiling.span("train.key", steps=self.k):
            tensors = carried_tensors(state) + _leaves(state.get("static"))
            return ((self.k, self.stacked, str(self.carry_dtype), self.mesh),
                    kernel_switches(), _signature(batches), _signature(draws),
                    tuple(map(id, tensors)))

    def __call__(self, state, batches, generator=None, draws=None, capture_only=False):
        """Run the steps; returns (state, losses): (k,) when stacked, else
        0-d.  ``capture_only`` captures (on the card) and steps nothing."""
        device = state["device_step"].device
        if device.type != "cuda" or not self.cuda_graphs:
            if capture_only:
                return state, None
            loss = self._eager(state, batches, generator, draws)
            return state, loss
        if self.mesh is not None and self.mesh.backend == "gloo":
            raise ValueError("a gloo collective cannot be captured in a CUDA graph; pass "
                             "cuda_graphs=False for a gloo mesh on the card")
        graphs = _graphs(self.step_fn, device)
        if draws is None:
            draws = self._draws(batches, torch.Generator(device).manual_seed(0)
                                if capture_only else generator)
        tensors = carried_tensors(state)

        def fn(static):
            return self._eager(state, static["batch"], None, static["draws"])

        def warmup(static):  # one eager run, then the state as it was
            snapshot = [t.detach().clone() for t in tensors]
            fn(static)
            with torch.no_grad():
                torch._foreach_copy_(tensors, snapshot)

        host_step = state["step"]
        try:
            loss = graphs.run(self._key(state, batches, draws), fn,
                              {"batch": batches, "draws": draws}, warmup,
                              holds=tensors + _leaves(state.get("static")),
                              replay=not capture_only)
        finally:
            state["step"] = host_step  # a capture runs the steps' host code, a replay none
        if capture_only:
            return state, None
        state["step"] += self.k
        return state, loss.clone()


def jit_train_step(step_fn: Callable, mesh=None, cuda_graphs: bool = True) -> Callable:
    """``(state, batch, generator=None, draws=None, local=False) -> (state,
    metrics)``: ``step_fn`` captured into a CUDA graph on the first call of a
    batch layout and state, replayed after (JAX :508, the jit boundary).
    Its ``aot_compile(state, batch)`` captures without stepping the state
    (the draws it captures with come from a generator of its own).

    With ``mesh`` (``parallel.mesh``) the step is data- and tensor-parallel
    over it: ``batch`` is the node's host batch, of which this rank takes
    its rows (``local=True``: it holds them already), and ``draws``, when
    given, the global batch's.  Under NCCL the gradient all-reduce is
    captured in the graph (the warm-up makes the communicator first); a gloo
    mesh needs ``cuda_graphs=False`` on the card.  Memoised per step
    function, mesh and ``cuda_graphs``."""
    cache = _per_fn_cache(step_fn, "_dft_jit_cache")
    memo = ("jit", mesh, cuda_graphs)
    if memo in cache:
        return cache[memo]
    steps = _Steps(step_fn, 1, None, stacked=False, mesh=mesh, cuda_graphs=cuda_graphs)

    def wrapper(state, batch, generator=None, draws=None, local=False):
        state, loss = steps(state, batch if local else steps.local(batch), generator, draws)
        return state, {"loss": loss}

    def aot_compile(state, batch, generator=None):
        steps(state, steps.local(batch), capture_only=True)
        return wrapper

    wrapper.aot_compile = aot_compile
    cache[memo] = wrapper
    return wrapper


def multi_step(step_fn: Callable, k: int, carry_dtype=None, mesh=None,
               cuda_graphs: bool = True) -> Callable:
    """Fuse ``k`` train steps into ONE CUDA graph (JAX :274, ``lax.scan``):
    ``(state, batches, generator=None, draws=None) -> (state, metrics)``,
    every ``batches`` leaf (and ``draws`` leaf, when given) ``(k, ...)``,
    ``metrics["loss"]`` ``(k,)``; the same result as ``k`` sequential
    ``step_fn`` calls with the generator's draws in their order.

    ``carry_dtype`` (a measurement knob, as in JAX) stores every fp32 tensor
    of the carried state -- parameters, moments, accumulator, LR scales --
    at that dtype between the k steps and after them, as JAX's hoisted
    carry does; unlike JAX (ROADMAP Queue C) it applies whether or not the
    state has a ``static`` entry.  ``mesh``, ``cuda_graphs`` and ``local``
    as in :func:`jit_train_step` (the batches' second axis holds the rows).
    Memoised per ``(step_fn, k, carry_dtype, mesh, cuda_graphs)``."""
    cache = _per_fn_cache(step_fn, "_dft_multi_step_cache")
    memo = (k, None if carry_dtype is None else str(carry_dtype), mesh, cuda_graphs)
    if memo in cache:
        return cache[memo]
    steps = _Steps(step_fn, k, carry_dtype, stacked=True, mesh=mesh, cuda_graphs=cuda_graphs)

    def fused(state, batches, generator=None, draws=None, local=False):
        state, losses = steps(state, batches if local else steps.local(batches), generator,
                              draws)
        return state, {"loss": losses}

    cache[memo] = fused
    return fused


class FusedDispatcher:
    """Drives a train step with ``spd``-step fused dispatch (JAX :359): full
    groups go through :func:`multi_step`'s graph, a one-off partial group
    (the run's tail) runs step by step through :func:`jit_train_step`, and a
    recurring group size gets its own graph on its second sight.  A group
    draws the same random numbers either way, so it gives the same result.
    ``mesh`` and ``cuda_graphs`` as in :func:`jit_train_step`: the groups
    are the node's host batches, each rank steps on its rows."""

    def __init__(self, step_fn: Callable, spd: int = 1, mesh=None, cuda_graphs: bool = True):
        self.spd = max(1, spd)
        self._step_fn = step_fn
        self.mesh, self.cuda_graphs = mesh, cuda_graphs
        self.jitted = (jit_train_step(step_fn, mesh, cuda_graphs) if self.spd == 1
                       else multi_step(step_fn, self.spd, mesh=mesh, cuda_graphs=cuda_graphs))
        self._fused = {self.spd: self.jitted} if self.spd > 1 else {}
        self._size_seen: Dict[int, int] = {}
        self._tail = self.jitted if self.spd == 1 else None
        self._copy_stream = None

    def _fused_for(self, n: int):
        fn = self._fused.get(n)
        if fn is not None:
            return fn
        self._size_seen[n] = self._size_seen.get(n, 0) + 1
        if self._size_seen[n] < 2:
            return None  # one-off tail: not worth a capture
        print(f"FusedDispatcher: compiling a second fused executable for recurring group "
              f"size {n} (spd={self.spd}); pick steps_per_dispatch dividing the save/eval "
              f"window to avoid the extra compile")
        fn = self._fused[n] = multi_step(self._step_fn, n, mesh=self.mesh,
                                         cuda_graphs=self.cuda_graphs)
        return fn

    def prepare(self, group):
        """Start the host-to-device move of a full group now, behind the
        dispatch in flight (JAX :418-440): the stacked batch goes into
        pinned host memory and is copied with ``non_blocking`` on a side
        stream; :meth:`run` makes its stream wait for that copy.  Returns a
        token for ``run(..., prepared=...)``, or None for groups that would
        run step by step (preparing never captures)."""
        n = len(group)
        if self.spd == 1 or n <= 1 or n not in self._fused:
            return None
        batches = stack_batches(group, self.mesh)
        device = getattr(self._step_fn, "device", None)
        if device is None or device.type != "cuda":
            return (n, batches, None, None)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        pinned = {k: None if v is None else torch.as_tensor(v).pin_memory()
                  for k, v in batches.items()}
        with torch.cuda.stream(self._copy_stream):
            on_device = {k: None if p is None else p.to(device, non_blocking=True)
                         for k, p in pinned.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return (n, on_device, done, pinned)

    def drive(self, state, rng, take_group, total_steps, start_step=0, draws=None):
        """The loop every trainer shares (JAX :442-471): ``take_group(step)
        -> list of batches`` supplies each group; yields ``(state, losses,
        stepped, step)`` after each dispatch, the next group's transfer
        already staged.  ``rng``: the ``torch.Generator`` the steps draw
        from; ``draws(step) -> draws`` hands each step's draws in instead
        (the parity tests).  While torch's profiler is on, each dispatch
        is a ``train.dispatch`` span, the group's steps and then the next
        group's ``train.take`` and ``train.stage``."""
        gs = start_step
        group, prepared = self._take(take_group, gs)
        while gs < total_steps and group:
            with profiling.span("train.dispatch", steps=len(group)):
                given = None if draws is None else [draws(gs + i) for i in range(len(group))]
                state, losses = self.run(state, group, rng, prepared=prepared, draws=given)
                stepped = len(group)
                gs += stepped
                nxt, prepared = (self._take(take_group, gs) if gs < total_steps
                                 else ([], None))
            yield state, losses, stepped, gs
            group = nxt

    def _take(self, take_group, gs):
        """The group of step ``gs`` and its staging (:meth:`prepare`)."""
        with profiling.span("train.take") as span:
            group = take_group(gs)
            span["steps"] = len(group)
        with profiling.span("train.stage"):
            return group, self.prepare(group)

    def run(self, state, group, generator=None, prepared=None, draws=None):
        """Run ``len(group)`` (<= spd) steps; returns (state, losses (n,)).
        ``prepared`` (from :meth:`prepare` on the same group) holds the
        stacked batch already on its way to the device; ``draws``, one per
        step, replaces the generator's."""
        n = len(group)
        if self.spd == 1:
            state, metrics = self.jitted(state, group[0], generator,
                                         draws=None if draws is None else draws[0])
            return state, metrics["loss"][None]
        fn = self._fused_for(n) if n > 1 else None
        if fn is not None:
            if prepared is not None and prepared[0] == n:
                batches, done = prepared[1], prepared[2]
                if done is not None:
                    stream = torch.cuda.current_stream(self._step_fn.device)
                    stream.wait_event(done)
                    for t in batches.values():
                        if t is not None:
                            t.record_stream(stream)
            else:
                batches = stack_batches(group, self.mesh)
            state, metrics = fn(state, batches, generator,
                                draws=None if draws is None else stack_batches(draws),
                                local=True)
            return state, metrics["loss"]
        if self._tail is None:
            self._tail = jit_train_step(self._step_fn, self.mesh, self.cuda_graphs)
        losses = []
        for i, batch in enumerate(group):
            state, metrics = self._tail(state, batch, generator,
                                        draws=None if draws is None else draws[i])
            losses.append(metrics["loss"])
        return state, torch.stack(losses)
