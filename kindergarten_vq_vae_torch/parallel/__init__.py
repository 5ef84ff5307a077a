"""Multi-device training: the mesh, its sharding rules and collectives
(:mod:`.mesh`), and the multi-process dry run (:mod:`.dryrun`)."""

from kindergarten_vq_vae_torch.parallel.mesh import (
    Mesh,
    TPShards,
    dp_axes,
    init_distributed,
    make_mesh,
    param_sharding_rules,
    shard_batch,
)

__all__ = ["Mesh", "TPShards", "dp_axes", "init_distributed", "make_mesh",
           "param_sharding_rules", "shard_batch"]
