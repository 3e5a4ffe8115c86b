"""Full train-state checkpoint and resume (port of the JAX package's
``training/checkpoint.py``).

The reference checkpoints only LoRA deltas and TI embeds, never the
optimiser state (resume = re-inject saved weights).  This module saves the
whole train state of ``train_step.init_train_state`` but its ``static``
entry: the parameters (LoRA masters, ``scale`` leaves, TI embeddings), the
optimiser state's tensors (moments, accumulator, counts, LR scales), the
host ``step`` and the ``device_step``.  The frozen models are not saved;
they load from the model directory.

A checkpoint is ``ckpt_dir/step_N/state.pt``, a ``torch.save`` of
``{"tensors": {name: tensor}, "structure": [[name, shape, dtype], ...],
"step": N}``, written into ``step_N.tmp`` and renamed, so a run stopped
mid-save never leaves a truncated ``step_N`` behind; the last ``keep``
checkpoints are kept.  :func:`restore_train_state` reads it with
``torch.load(weights_only=True)`` onto the state's device, refuses a
checkpoint whose structure (names, shapes, dtypes) differs from the
target's, as JAX's treedef check does (:104-112), and copies every tensor
INTO the target's tensors: a train step captured into a CUDA graph reads
those tensors by address, so it replays the restored state with no new
capture.  After a restore the state is bit-equal to the one saved.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from .optim import OptimizerState

STATE_FILE = "state.pt"


def _named(tree: Any, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, OptimizerState):
        out[f"{prefix}/count"] = tree.count
        out[f"{prefix}/mini_step"] = tree.mini_step
        for part in ("moments", "acc", "lr_scale"):
            _named(getattr(tree, part), f"{prefix}/{part}", out)
    elif isinstance(tree, Mapping):
        for key in sorted(tree):
            if tree[key] is not None:
                _named(tree[key], f"{prefix}/{key}", out)


def named_tensors(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{name: tensor} of everything a checkpoint holds: the state but its
    ``static`` entry and its host ``step``.  The optimiser's parameter lists
    are the ``params`` tensors themselves and are not named twice."""
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(state):
        if key not in ("static", "step"):
            _named(state[key], key, out)
    return out


def _structure(tensors: Mapping[str, torch.Tensor]) -> List[Tuple[str, Tuple[int, ...], str]]:
    return [(k, tuple(t.shape), str(t.dtype)) for k, t in tensors.items()]


def _steps(ckpt_dir: str) -> List[int]:
    return sorted(int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and d.split("_", 1)[1].isdigit())


def save_train_state(ckpt_dir: str, state: Mapping[str, Any], step: Optional[int] = None,
                     keep: int = 3) -> str:
    """Save ``state`` (without ``static``) under ``ckpt_dir/step_N``
    atomically; returns the path.  Only the saved tensors go to the host,
    after the device has finished the work in flight (a graph replay may
    still be writing them)."""
    tensors = named_tensors(state)
    if any(t.is_cuda for t in tensors.values()):
        torch.cuda.synchronize()
    host = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}
    step = int(step if step is not None else state.get("step", 0))
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step}")
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"tensors": host, "structure": [list(s) for s in _structure(tensors)],
                "step": int(state.get("step", step))}, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{old}"), ignore_errors=True)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``step_N`` under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{steps[-1]}")


@torch.no_grad()
def restore_train_state(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """Copy the checkpoint at ``path`` into ``target`` in place (its
    ``static`` entry untouched) and return it.  Raises ValueError when the
    checkpoint's names, shapes or dtypes differ from the target's."""
    tensors = named_tensors(target)
    device = next(iter(tensors.values())).device
    saved = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                       weights_only=True)
    if [tuple(s[:1]) + (tuple(s[1]), s[2]) for s in saved["structure"]] != _structure(tensors):
        raise ValueError(
            f"checkpoint at {path} has a different state structure than the restore "
            "target (optimizer/config drift?); refusing to misassign leaves")
    torch._foreach_copy_(list(tensors.values()), [saved["tensors"][k] for k in tensors])
    if "step" in target:
        target["step"] = int(saved["step"])
    return target
