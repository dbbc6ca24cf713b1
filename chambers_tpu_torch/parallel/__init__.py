"""Data, tensor, fully-sharded, expert, pipeline and context parallelism
over ``torch.distributed`` (port of ``chambers_tpu/parallel``): the same
names as the JAX package's ``parallel``. Meshes are ``DeviceMesh``
objects; see ``sharding`` for how a placed module computes."""

from chambers_tpu_torch.parallel.mesh import create_mesh
from chambers_tpu_torch.parallel.distributed import (
    host_local_batch_to_global,
    init_distributed,
)
from chambers_tpu_torch.parallel.collective_eval import (
    distributed_pairwise_scores,
    distributed_recall_at_k,
)
from chambers_tpu_torch.parallel.context_parallel import (
    context_parallel_attention,
)
from chambers_tpu_torch.parallel.expert_parallel import (
    moe_expert_parallel_rules,
)
from chambers_tpu_torch.parallel.fsdp import fsdp_rules
from chambers_tpu_torch.parallel.pipeline_parallel import (
    group_layers_into_stages,
    pipeline_apply,
    shard_pipeline_params,
    stack_pipeline_stages,
)
from chambers_tpu_torch.parallel.sharding import (
    SEQ2SEQ_TENSOR_PARALLEL_RULES,
    VIT_TENSOR_PARALLEL_RULES,
    batch_sharding,
    make_param_shardings,
    replicate,
    shard_batch,
    shard_params,
    shard_quantized,
)
