"""Serving over several devices: independent streams, row-split frames
and the two-stage pipeline; and the data-parallel mesh for training
(``parallel.mesh``: one rank per shard)."""

from joshupscale_torch.parallel.pipeline import PipelinedEngine
from joshupscale_torch.parallel.serving import ShardedEngine, SpatialEngine

__all__ = ["PipelinedEngine", "ShardedEngine", "SpatialEngine"]
