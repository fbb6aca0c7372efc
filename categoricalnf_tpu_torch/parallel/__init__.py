from categoricalnf_tpu_torch.parallel.eval import make_task_sharded_iw_eval
from categoricalnf_tpu_torch.parallel.mesh import (DATA_AXIS, SAMPLE_AXIS,
                                                   Mesh, create_mesh,
                                                   maybe_init_distributed,
                                                   shard_batch)

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "Mesh", "create_mesh",
           "make_task_sharded_iw_eval", "maybe_init_distributed",
           "shard_batch"]
