"""Frame-level pipeline functions."""

from foveax_torch.pipeline.frames import FoveationPipeline

__all__ = ["FoveationPipeline"]
