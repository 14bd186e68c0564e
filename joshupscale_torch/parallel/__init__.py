"""Multi-stream and pipelined serving."""

from joshupscale_torch.parallel.pipeline import PipelinedEngine
from joshupscale_torch.parallel.serving import ShardedEngine

__all__ = ["PipelinedEngine", "ShardedEngine"]
