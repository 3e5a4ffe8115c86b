"""Device meshes on ``torch.distributed`` (port of the JAX package's
``parallel/mesh.py``).

JAX drives every device from one process and XLA inserts the collectives;
PyTorch runs one process per rank and every collective is explicit.  The
port maps the JAX contract one to one:

* a JAX *device* is a port *rank*; a JAX *process* is a port *node*
  (:func:`process_count` is ``world_size // local_world_size``), so the
  same flags on the same number of devices give the same global batch and
  the same ``--scale_lr`` factor;
* :class:`Mesh` lays the ranks out row-major over its axes (``("data",)``
  or ``("data", "tp")``) and holds one process group per axis, the line of
  ranks this rank shares that axis with, plus one over the whole mesh;
* every collective of the port goes through this module and uses only
  ``all_reduce`` and ``broadcast``, which NCCL and gloo both run on CUDA
  tensors; a gather is an ``all_reduce`` of a zero-padded buffer.  One code
  path then serves gloo on the CPU, gloo with two ranks sharing one card
  (NCCL refuses two ranks on one device) and NCCL on several cards.

The backend and the device are the caller's choice
(:func:`initialize_distributed`): NCCL on ``cuda``, gloo on the CPU or when
asked for.  A rank's device defaults to ``cuda:{LOCAL_RANK}``.  Nothing
falls back to another backend or device.

Placements (:func:`fsdp_shardings`, :func:`tp_shardings`) are JAX's rules
returned as per-leaf partition specs, tuples with one entry per dimension
(``None`` or the axis name; ``()`` replicates), the ``tuple`` of JAX's
``PartitionSpec``.  ``parallel/tp.py`` executes the tensor-parallel one on
the models as Megatron pairs.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

Spec = Tuple[Optional[str], ...]


def _world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_world_size() -> int:
    """Ranks on this node: torchrun's ``LOCAL_WORLD_SIZE``, else every rank
    (one node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", _world()[1]))


def process_count() -> int:
    """The number of nodes, JAX's ``process_count()``."""
    return max(1, _world()[1] // local_world_size())


def rank_device(device="cuda") -> torch.device:
    """The device this rank runs on: ``device`` as given, except that a bare
    ``"cuda"`` under a process group (or torchrun's environment) means
    ``cuda:{LOCAL_RANK}``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """The ranks ``0 .. n-1`` laid out row-major over ``axis_names`` with
    sizes ``shape`` (a dict, as JAX's ``mesh.shape``).  ``coords`` is this
    rank's index along each axis; ``groups[axis]`` the process group of the
    ranks that differ from this one only along ``axis``; ``group`` the whole
    mesh's.  Tensors a collective reduces live on ``device``."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Any]
    group: Any
    device: torch.device
    backend: str

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def make_mesh(num_devices: Optional[int] = None, axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A mesh over the first ``num_devices`` ranks (default all), 1-D over
    ``data`` unless ``shape`` says otherwise.  Needs a process group
    (:func:`initialize_distributed`); every rank of it must call this, and a
    rank outside the mesh raises once the groups are made (their creation
    is collective over the world).  ``device`` defaults to
    :func:`rank_device` of ``cuda`` under NCCL, else the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed(...) on every rank first")
    rank, world = _world()
    n = num_devices or world
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axes)} must hold {n} ranks")
    if n > world:
        raise ValueError(f"a mesh of {n} ranks needs {n} processes; the group has {world}")
    grid = np.arange(n).reshape(shape)
    groups: Dict[str, Any] = {}
    for ax in range(len(axes)):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:  # every rank creates every group, in one order
            members = [int(r) for r in line]
            g = dist.new_group(members)
            if rank in members:
                groups[axes[ax]] = g
    whole = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh of {n} ranks {dict(zip(axes, shape))}")
    backend = dist.get_backend()
    if device is None:
        device = rank_device("cuda") if backend == "nccl" else torch.device("cpu")
    coords = dict(zip(axes, (int(i) for i in np.unravel_index(rank, shape))))
    return Mesh(tuple(axes), dict(zip(axes, shape)), rank, coords, groups, whole,
                torch.device(device), backend)


def trainer_mesh(eff_batch: int, tensor_parallel: int = 1, device=None) -> Optional[Mesh]:
    """A trainer's mesh, or None for one device (JAX :171-196): ``tp`` must
    divide the world; ``data`` is the largest count up to ``world // tp``
    that divides the effective per-step batch.  ``tp == 1`` keeps the 1-D
    ``("data",)`` mesh.  Under torchrun's environment (``WORLD_SIZE`` > 1)
    the process group is initialised first if it is not up."""
    if int(os.environ.get("WORLD_SIZE", 1)) > 1 and not dist.is_initialized():
        initialize_distributed(device=device or "cuda")
    world = _world()[1]
    tp = max(1, tensor_parallel)
    if world % tp or world < tp:
        raise ValueError(f"tensor_parallel={tp} does not divide device count {world}")
    avail = world // tp
    data = max(d for d in range(1, avail + 1) if eff_batch % d == 0)
    if data * tp == 1:
        return None
    if tp == 1:
        return make_mesh(num_devices=data, device=device)
    return make_mesh(num_devices=data * tp, axes=("data", "tp"), shape=(data, tp),
                     device=device)


# ---------------------------------------------------------------------------
# placements (JAX's rules as per-leaf specs)
# ---------------------------------------------------------------------------


def data_sharding(mesh: Mesh) -> Spec:
    """Batch-dim sharding over the data axis."""
    return ("data",)


def replicated(mesh: Mesh) -> Spec:
    return ()


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def fsdp_shardings(mesh: Mesh, tree: Any, axis: str = "fsdp", min_size: int = 2 ** 16) -> Any:
    """Per-leaf specs splitting each large leaf's largest dimension that
    ``mesh.shape[axis]`` divides (ZeRO-3 style, JAX :87-111); small or
    indivisible leaves replicate."""
    n = mesh.shape[axis]

    def leaf(_, x):
        shape = tuple(np.shape(x))
        if n == 1 or int(np.prod(shape, dtype=np.int64)) < min_size:
            return ()
        best = None
        for d, s in enumerate(shape):
            if s % n == 0 and (best is None or s > shape[best]):
                best = d
        if best is None:
            return ()
        return tuple(axis if d == best else None for d in range(len(shape)))

    return _tree_map(leaf, tree)


# Megatron placement (JAX :125-130): "col" splits a kernel's output
# features, "row" its input features.  parallel/tp.py executes the
# attention and feed-forward pairs of these sets; see there for proj_in and
# proj_out, which it keeps replicated.
TP_COL = {"to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "proj", "fc1", "proj_in"}
TP_ROW = {"to_out", "out_proj", "net_2", "fc2", "proj_out"}


def tp_shardings(mesh: Mesh, tree: Any, axis: str = "tp") -> Any:
    """Per-leaf specs of tensor parallelism for a JAX-layout parameter tree
    (``kernel`` (in, out), ``bias`` (out,)), JAX's rule (:133-168): column
    kernels split their output dimension, row kernels their input one,
    column biases follow their kernel; indivisible dimensions and every
    other leaf replicate."""
    n = mesh.axis_size(axis)

    def leaf(path, x):
        shape = tuple(np.shape(x))
        if n <= 1 or len(path) < 2:
            return ()
        module, param = path[-2], path[-1]
        if param == "kernel" and len(shape) == 2:
            if module in TP_COL and shape[1] % n == 0:
                return (None, axis)
            if module in TP_ROW and shape[0] % n == 0:
                return (axis, None)
        elif param == "bias" and module in TP_COL and len(shape) == 1 and shape[0] % n == 0:
            return (axis,)
        return ()

    return _tree_map(leaf, tree)


def tp_state_shardings(mesh: Mesh, state: Any, axis: str = "tp") -> Any:
    """Specs for a train state (JAX :199-216): every leaf replicates except
    the frozen ``static["unet_params"]`` / ``["text_params"]`` trees, which
    take :func:`tp_shardings`.  The port's state holds no frozen weights
    (they live in the modules, which :func:`parallel.tp.shard_models`
    splits), so for it this replicates the LoRA/TI leaves, the optimiser
    state and the rest, as JAX does."""
    def rep(tree):
        if isinstance(tree, dict):
            return {k: rep(v) for k, v in tree.items()}
        return ()

    out = rep(dict(state))
    static = state.get("static") if isinstance(state, dict) else None
    if isinstance(static, dict):
        for key in ("unet_params", "text_params"):
            if key in static:
                out["static"][key] = tp_shardings(mesh, static[key], axis=axis)
    return out


# ---------------------------------------------------------------------------
# collectives: all_reduce and broadcast only
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in place."""
    dist.broadcast(t, src=src, group=group)
    return t


def gather_rows(local: torch.Tensor, index: int, count: int, group) -> torch.Tensor:
    """The ``count`` equal row blocks of ``group``'s ranks stacked in order
    of ``index``: each rank's block in a zero-padded buffer, summed over
    the group (exact: one addend per element is not zero)."""
    rows = local.shape[0]
    wide = local.dtype if local.dtype.is_floating_point else torch.int32
    buf = torch.zeros((count * rows,) + tuple(local.shape[1:]), dtype=wide,
                      device=local.device)
    buf[index * rows:(index + 1) * rows] = local
    all_reduce(buf, group)
    return buf.to(local.dtype)


def broadcast_object(obj: Any, mesh: Mesh, src: int = 0) -> Any:
    """A picklable object from mesh rank ``src`` to every rank of the mesh
    (its length, then its bytes, each by one broadcast on the mesh's
    device); every rank returns it."""
    if mesh.rank == src:
        payload = pickle.dumps(obj)
        size = torch.tensor([len(payload)], dtype=torch.int64, device=mesh.device)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=mesh.device)
    broadcast(size, src, mesh.group)
    n = int(size.item())
    if mesh.rank == src:
        data = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(mesh.device)
    else:
        data = torch.empty(n, dtype=torch.uint8, device=mesh.device)
    broadcast(data, src, mesh.group)
    return obj if mesh.rank == src else pickle.load(io.BytesIO(data.cpu().numpy().tobytes()))


# ---------------------------------------------------------------------------
# batches and trees
# ---------------------------------------------------------------------------


def node_data_slots(mesh: Mesh) -> Tuple[int, int]:
    """(this rank's index among its node's data slots, the slots per node):
    the node's host batch splits over that many ranks along ``data``."""
    d, n_data = mesh.index("data"), mesh.axis_size("data")
    nodes = process_count()
    if n_data % nodes:
        raise ValueError(f"the data axis ({n_data}) must split evenly over {nodes} nodes")
    per_node = n_data // nodes
    return d % per_node, per_node


def gather_node_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The nodes' copies of a host-batch leaf end to end (every rank of a
    node holds the node's): the first data rank of each node writes its
    node's rows into a zero-padded buffer, summed over ``data``.  One node:
    ``x`` itself."""
    nodes = process_count()
    if nodes == 1:
        return x
    slot, slots = node_data_slots(mesh)
    rows = x.shape[0]
    buf = torch.zeros((nodes * rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if slot == 0:
        node = mesh.index("data") // slots
        buf[node * rows:(node + 1) * rows] = x
    return all_reduce(buf, mesh.groups["data"])


def batch_rows(mesh: Mesh, local_rows: int) -> Tuple[int, int]:
    """(first global row this rank holds, rows in the global batch) for a
    rank holding ``local_rows`` rows: the global batch is the nodes' host
    batches end to end, split over ``data`` in order."""
    n_data = mesh.axis_size("data")
    return mesh.index("data") * local_rows, n_data * local_rows


def local_rows(batch: Dict[str, Any], mesh: Mesh, axis: int = 0) -> Dict[str, Any]:
    """This rank's rows of the node's host batch along ``axis`` (1 for
    ``multi_step``'s stacked batches), leaves kept as the type they are.
    ``mask`` stays whole: a face mask's rows belong to the instance half of
    a prior-preservation batch, not to the rank's rows, and the loss finds
    its rows in the gathered global mask."""
    slot, slots = node_data_slots(mesh)
    out = {}
    for k, v in batch.items():
        if v is None or k == "mask" or slots == 1:
            out[k] = v
            continue
        b = v.shape[axis]
        if b % slots:
            raise ValueError(f"batch {k!r} has {b} rows along axis {axis}, not a multiple "
                             f"of the {slots} data ranks of this node")
        n = b // slots
        idx = (slice(None),) * axis + (slice(slot * n, (slot + 1) * n),)
        out[k] = v[idx]
    return out


def shard_batch(batch: Dict[str, Any], mesh: Mesh, spec: Optional[Spec] = None
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch, on the mesh's device (JAX :52-79):
    its rows along the spec's ``data`` dimension (``("data",)`` by default,
    ``(None, "data")`` for batches stacked on a leading steps axis)."""
    spec = ("data",) if spec is None else tuple(spec)
    axis = spec.index("data") if "data" in spec else 0
    part = local_rows(batch, mesh, axis)
    return {k: None if v is None else torch.as_tensor(v).to(mesh.device)
            for k, v in part.items()}


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, np.ndarray):
        return fn(torch.from_numpy(tree))
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    tensors = getattr(tree, "tensors", None)
    if callable(tensors):  # an optimiser state: its tensors, in place
        for t in tensors():
            fn(t)
    return tree


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` as mesh rank 0 holds it: tensors already on
    the mesh's device are overwritten in place (a train state keeps its
    tensors), others are copied there first."""
    @torch.no_grad()
    def put(t):
        if t.device != mesh.device:
            t = t.to(mesh.device)
        return broadcast(t, 0, mesh.group)  # the mesh's rank 0 is global rank 0

    return _map_tensors(put, tree)


def shard_tree(tree: Any, shardings: Any, mesh: Mesh) -> Any:
    """Each leaf placed by its spec on ``mesh``: replicated leaves (``()``)
    as :func:`replicate` does, split ones cut to this rank's block along
    the named dimension.  A spec tree may stop above the leaves (a train
    state's optimiser state is one ``()``)."""

    def walk(t, sh):
        if isinstance(sh, dict):
            return {k: walk(t[k], sh[k]) for k in sh}
        if not sh or not any(sh):
            return replicate(t, mesh)
        x = torch.as_tensor(t).to(mesh.device)
        for dim, ax in enumerate(sh):
            if ax is not None:
                n, i = mesh.axis_size(ax), mesh.index(ax)
                w = x.shape[dim] // n
                x = x.narrow(dim, i * w, w).contiguous()
        return x

    return walk(tree, shardings)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: Optional[str] = None,
                           device="cuda") -> None:
    """Start the process group (JAX :219-231; the reference's Accelerate
    NCCL init).  With ``num_processes`` > 1: rank ``process_id`` of that
    many, meeting at ``coordinator_address`` (``host:port``, or a
    ``tcp://`` / ``file://`` URL).  Without arguments: torchrun's
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``), a no-op when it
    names one process.  ``backend`` defaults to NCCL on ``cuda`` and gloo on
    the CPU; pass gloo for several ranks on one card."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
        if num_processes > 1:
            coordinator_address = coordinator_address or "env://"
            process_id = int(os.environ["RANK"]) if process_id is None else process_id
    if num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    url = coordinator_address or "env://"
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


def is_main_process() -> bool:
    """I/O gating: global rank 0 (JAX :234)."""
    return _world()[0] == 0


def barrier(name: str = "barrier") -> None:
    """Every rank waits for the others (JAX :240; ``accelerator.
    wait_for_everyone()``).  ``name`` labels the call site."""
    if _world()[1] > 1:
        dist.barrier()


_BARRIER_GEN: Dict[str, int] = {}


def coordination_barrier(name: str = "sync", timeout_s: float = 1200.0) -> None:
    """A barrier on the process group's store that touches no device (JAX
    :249-261): each rank adds one to a key of the call's name and
    generation, then waits until every rank has."""
    rank, world = _world()
    if world <= 1:
        return
    gen = _BARRIER_GEN.get(name, 0)
    _BARRIER_GEN[name] = gen + 1
    store = dist.distributed_c10d._get_default_store()
    key = f"dft_barrier/{name}/{gen}"
    store.add(key, 1)
    deadline = time.monotonic() + timeout_s
    while store.add(key, 0) < world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"coordination_barrier({name!r}) timed out after {timeout_s} s")
        time.sleep(0.005)


def local_batch_size(global_batch_size: int) -> int:
    n = process_count()
    assert global_batch_size % n == 0, (
        f"global batch {global_batch_size} must divide process count {n}")
    return global_batch_size // n
