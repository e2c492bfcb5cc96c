"""Multi-process execution of the port: the process group, the mesh and
the placements (``sonicdiffusionbayeslab_tpu/parallel``'s names)."""

from sonicdiffusionbayeslab_torch.parallel.distributed import (  # noqa: F401
    all_sum_array,
    all_sum_scalar,
    initialize,
)
from sonicdiffusionbayeslab_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    latent_sharding,
    make_mesh,
    param_sharding_rules,
    shard_batch,
    shard_latents,
    shard_params,
)
