"""Parallelism (port of pope_tpu/parallel): the launch ladder and process
group, collectives, the (dp, tp) mesh with its sharding rules, and GPipe.

`pope_tpu` shards one program over a jax.sharding.Mesh and lets XLA insert
the collectives; here each device has a process (a rank), a
torch.distributed DeviceMesh names the axes, and the sharded programs call
the collectives themselves. Every sharded program computes what its
unsharded one computes on the global batch, up to the rounding of another
reduction order.
"""

from pope_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    shard_params_tp,
    replicate,
)
from pope_tpu_torch.parallel.launch import (
    DistributedEnv,
    launch,
    resolve_env,
    spawn,
)
from pope_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_loss_and_grad,
    shard_stage_params,
    stack_stage_params,
)
