"""The parallel modes on ``torch.distributed``: the rank grid and data
parallelism (``mesh``), start-up and collectives (``distributed``), tensor
parallelism (``tp``), and time sharding of SSRN (``sp``) and Griffin-Lim
(``sp_gl``)."""
from .mesh import (make_mesh, param_partition_specs, shard_batch,  # noqa
                   host_device_count)
from .tp import gather_params, shard_params  # noqa
