from pynqs_tpu_torch.parallel.launch import rank_device, run_ranks  # noqa: F401
from pynqs_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce_max,
    all_reduce_sum,
    generators_in_sync,
    init_mesh,
    make_mesh,
    rand_rows,
    rank_generator,
    replicated_check,
    shard_batch,
)
