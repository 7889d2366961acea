"""Frame-level pipeline functions (counterpart of
``foveax/pipeline/frames.py``) for the fused path.

    foveate(frame, center)            fused sampler, (H, W, 3) -> (Hr, Wr, 3)
    unwarp(reduced, center)           exact unwarp back to (H, W, 3)
    unwarp_auto(reduced, center)      fused unwarp (the kernels)
    roundtrip(frame, center)          foveate + exact unwarp
    sample_batch_fused(frame, cs)     one frame, N gazes, one launch per pass

The ``_chw`` variants take and return channel-planar (3, H, W) frames, the
layout of the device-resident hot path.  Gaze centres are runtime tensors:
a moving gaze rebuilds nothing.  The sampler is the fused one, with the
360 wrap on x; the SAT sampler comes with a later part of the port, so an
ineligible shape raises instead of degrading to it.
"""

from __future__ import annotations

import torch

from foveax_torch.config import FoveaxConfig
from foveax_torch.core.logrect import LogRectGrid, make_grid
from foveax_torch.core.unwarp import unwarp_rect
from foveax_torch.device import resolve_device
from foveax_torch.kernels.segreduce import (
    fused_eligible,
    sample_rect_fused,
    sample_rect_fused_batch,
)


def _identity(frame: torch.Tensor) -> torch.Tensor:
    """"prepare" of the SAT-free pairs: the staged frame is the prepared
    state."""
    return frame


class FoveationPipeline:
    """Pipeline for one (source, reduced) shape configuration on one
    device (``cuda`` unless ``device="cpu"`` is passed).  Stateless apart
    from the grid: one instance serves any number of connections."""

    def __init__(
        self,
        config: FoveaxConfig | None = None,
        *,
        device: str | torch.device | None = None,
    ):
        self.config = config or FoveaxConfig()
        self.device = resolve_device(device)
        cfg = self.config
        self.grid: LogRectGrid = make_grid(
            cfg.reduced_width, cfg.reduced_height, cfg.source_width,
            cfg.source_height, self.device,
        )
        if not fused_eligible(self.grid):
            raise ValueError(
                f"{cfg.source_width}x{cfg.source_height} -> "
                f"{cfg.reduced_width}x{cfg.reduced_height} is outside the "
                "fused sampler's contract"
            )

    # -- single gaze ------------------------------------------------------

    def foveate(self, frame, center):
        return sample_rect_fused(frame, self.grid, center, in_layout="hwc")

    def foveate_chw(self, frame, center):
        return sample_rect_fused(frame, self.grid, center, out_layout="chw")

    def unwarp(self, reduced, center):
        cfg = self.config
        return unwarp_rect(reduced, cfg.source_width, cfg.source_height, center)

    def unwarp_chw(self, reduced, center):
        cfg = self.config
        return unwarp_rect(
            reduced, cfg.source_width, cfg.source_height, center,
            in_layout="chw", out_layout="chw",
        )

    def unwarp_auto(self, reduced, center):
        """The fused unwarp: <= 1 LSB of exact, fovea bit-exact."""
        cfg = self.config
        return unwarp_rect(
            reduced, cfg.source_width, cfg.source_height, center,
            precision="auto",
        )

    def unwarp_auto_chw(self, reduced, center):
        cfg = self.config
        return unwarp_rect(
            reduced, cfg.source_width, cfg.source_height, center,
            in_layout="chw", out_layout="chw", precision="auto",
        )

    def roundtrip(self, frame, center):
        reduced = self.foveate(frame, center)
        return reduced, self.unwarp(reduced, center)

    def roundtrip_chw(self, frame, center):
        reduced = self.foveate_chw(frame, center)
        return reduced, self.unwarp_chw(reduced, center)

    # -- gaze batches -----------------------------------------------------

    def sample_batch_fused(self, frame, centers):
        """(H, W, 3) frame + (N, 2) centres -> (N, Hr, Wr, 3)."""
        return sample_rect_fused_batch(frame, self.grid, centers, in_layout="hwc")

    def batch_pair(self, batch_sampler: str = "auto"):
        """The serve tick's device pair ``(prepare, sample_batch)``:
        ``prepare(frame_hwc)`` once per source frame,
        ``sample_batch(prepared, centers)`` once per member batch."""
        if batch_sampler in ("auto", "fused"):
            return _identity, self.sample_batch_fused
        raise ValueError(
            f"batch_sampler {batch_sampler!r}: only the fused sampler is "
            "ported"
        )

    def single_pair(self):
        """(prepare, sample) for the single-session serve loop: the fused
        sampler has no gaze-independent prepare stage."""
        return _identity, self.foveate

    # -- convenience ------------------------------------------------------

    def center(self, cx: float, cy: float) -> torch.Tensor:
        return torch.tensor([cx, cy], dtype=torch.float32, device=self.device)

    @property
    def reduced_shape(self) -> tuple[int, int, int]:
        return (self.config.reduced_height, self.config.reduced_width, 3)

    @property
    def source_shape(self) -> tuple[int, int, int]:
        return (self.config.source_height, self.config.source_width, 3)
