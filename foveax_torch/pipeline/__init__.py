"""Frame-level pipeline functions, and the port's tracer
(:mod:`foveax_torch.pipeline.profiling`), which the kernels and core
modules import: so ``FoveationPipeline`` is loaded at first use, not with
the package."""

__all__ = ["FoveationPipeline"]


def __getattr__(name: str):
    if name == "FoveationPipeline":
        from foveax_torch.pipeline.frames import FoveationPipeline

        return FoveationPipeline
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
