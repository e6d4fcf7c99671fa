"""Data parallelism across processes, one device each: the port's
counterpart of ``seld_tpu/parallel`` (its data axis; tensor parallelism is
not ported)."""

from seld_tpu_torch.parallel import multihost  # noqa: F401
from seld_tpu_torch.parallel.cross_rank import CrossRank  # noqa: F401
from seld_tpu_torch.parallel.dp_step import make_dp_train_step, replicate_state  # noqa: F401
from seld_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, batch_sharding, make_mesh, shard_batch,
)
