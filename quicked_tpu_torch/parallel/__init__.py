from quicked_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    run_banded_sharded,
    run_windowed_sharded,
    shard_lanes,
)
