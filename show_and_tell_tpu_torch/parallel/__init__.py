"""Multi-device training and serving over ``torch.distributed``."""

from show_and_tell_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    param_shardings,
    replicate,
    shard_batch,
)
