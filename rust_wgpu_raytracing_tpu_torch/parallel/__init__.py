"""Multi-device rendering on torch.distributed (JAX parallel/): row slabs
and samples (tile_sharding), face shards (geometry_sharding), the rank
mesh (mesh) and a launcher (launch)."""

from .tile_sharding import (dryrun_multichip, make_render_mesh,
                            render_sharded, render_sharded_megakernel)

__all__ = ["render_sharded", "render_sharded_megakernel",
           "make_render_mesh", "dryrun_multichip"]
