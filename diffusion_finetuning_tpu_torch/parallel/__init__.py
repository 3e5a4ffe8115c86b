"""Multi-device execution of the port on ``torch.distributed`` (JAX
``parallel/``): meshes, placements and collectives (``mesh.py``), and the
Megatron split of the frozen projections (``tp.py``)."""

from .mesh import (  # noqa: F401
    barrier,
    data_sharding,
    initialize_distributed,
    is_main_process,
    local_batch_size,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
