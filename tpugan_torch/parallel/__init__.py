"""Parallelism over ranks joined by ``torch.distributed`` (port of
``tpugan/parallel``): the multi-process bootstrap (``multihost``), data
parallel meshes (``mesh``), the differentiable collectives the JAX
package gets from XLA (``collectives``), FSDP (``fsdp``), spatial halo
convs (``spatial``) and batch-parallel serving (``inference``)."""

from tpugan_torch.parallel.mesh import (  # noqa: F401
    all_gather_arrays,
    make_mesh,
    replicate,
    shard_batch,
    shard_train_state,
)
from tpugan_torch.parallel.fsdp import (  # noqa: F401
    make_mesh_2d,
    shard_params_fsdp,
    shard_train_state_fsdp,
)
from tpugan_torch.parallel.inference import ShardedSampler  # noqa: F401
