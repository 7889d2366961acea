"""Frame-level pipeline functions (counterpart of
``foveax/pipeline/frames.py``).

    foveate(frame, center)            (H, W, 3) -> (Hr, Wr, 3), by the
                                      resolved sampler
    build_sat(frame)                  SAT build (kernel K5 on the card)
    sample(sat, center)               4-tap sample of a built SAT
    unwarp(reduced, center)           exact unwarp back to (H, W, 3)
    unwarp_auto(reduced, center)      fused unwarp (the kernel) where its
                                      contract holds, exact elsewhere
    roundtrip(frame, center)          foveate + exact unwarp
    foveate_batch(frame, centers)     one SAT, N gazes
    sample_batch_fused(frame, cs)     one frame, N gazes, one launch per pass
    sample_batch_direct(frame, cs)    one frame, N gazes, no SAT, no kernel
    default_pipeline(device)          the default configuration's pipeline,
                                      cached per device

The ``_chw`` variants take and return channel-planar (3, H, W) frames, the
layout of the device-resident hot path.  Gaze centres are runtime tensors:
a moving gaze rebuilds nothing.

Samplers: "fused" (the one-launch segment-reduce kernel, no SAT), "sat"
(SAT build K5, then the 4-tap sampler), "direct" (the banded SAT-free
sampler of :mod:`foveax_torch.core.direct`, plain PyTorch, exact at every
shape) or "auto": fused where the shape is inside the fused sampler's
contract, SAT otherwise, on every device (never direct, as in the JAX
package).  All three are bit-identical.  An explicit "fused" on a shape
outside the contract (:func:`fused_eligible`) raises: the port's uint16
row-sum bound, or a source row too wide for ``segment_reduce_xy``'s
shared memory (past 35,888 columns under the reduced-size rule).  The JAX
package's probe checks only its Pallas structure and admits some shapes
past the row-sum bound (1920x1080 -> 64x36), where its fused sampler
wraps its uint16 row sums.
"""

from __future__ import annotations

import functools

import torch

from foveax_torch.config import FoveaxConfig
from foveax_torch.core.direct import sample_rect_direct, sample_rect_direct_batch
from foveax_torch.core.logrect import LogRectGrid, make_grid
from foveax_torch.core.sample import sample_rect_from_sat
from foveax_torch.core.sat import build_sat
from foveax_torch.core.unwarp import unwarp_rect
from foveax_torch.device import resolve_device
from foveax_torch.kernels.segreduce import (
    MAX_SHARED_BYTES,
    fused_eligible,
    sample_rect_fused,
    sample_rect_fused_batch,
    xy_shared_bytes,
)
from foveax_torch.pipeline import profiling

SAMPLERS = ("sat", "fused", "direct")


def _identity(frame: torch.Tensor) -> torch.Tensor:
    """"prepare" of the SAT-free pairs: the staged frame is the prepared
    state."""
    return frame


def _check_sampler(sampler: str) -> None:
    if sampler not in (*SAMPLERS, "auto"):
        raise ValueError(
            f"sampler {sampler!r}: expected one of {', '.join(SAMPLERS)} "
            "or 'auto'"
        )


class FoveationPipeline:
    """Pipeline for one (source, reduced) shape configuration on one
    device (``cuda`` unless ``device="cpu"`` is passed).  Stateless apart
    from the grid: one instance serves any number of connections.
    ``self.sampler`` holds the resolved sampler, "fused", "sat" or
    "direct".  Building the grid on the device is a ``setup.pipeline``
    span."""

    def __init__(
        self,
        config: FoveaxConfig | None = None,
        *,
        wrap_x: bool = True,
        sampler: str = "auto",
        device: str | torch.device | None = None,
    ):
        _check_sampler(sampler)
        self.config = config or FoveaxConfig()
        self.wrap_x = wrap_x
        cfg = self.config
        with profiling.span(
            "setup.pipeline", source=(cfg.source_width, cfg.source_height),
            reduced=(cfg.reduced_width, cfg.reduced_height), sampler=sampler,
        ):
            self.device = resolve_device(device)
            self.grid: LogRectGrid = make_grid(
                cfg.reduced_width, cfg.reduced_height, cfg.source_width,
                cfg.source_height, self.device,
            )
        self.fused_ok = fused_eligible(self.grid)
        if sampler == "auto":
            sampler = "fused" if self.fused_ok else "sat"
        elif sampler == "fused" and not self.fused_ok:
            raise ValueError(
                f"{cfg.source_width}x{cfg.source_height} -> "
                f"{cfg.reduced_width}x{cfg.reduced_height} is outside the "
                f"fused sampler's contract: row step {self.grid.max_dy} "
                f"(needs 255 * max(dy) < 2^16), source width "
                f"{cfg.source_width} and output width {cfg.reduced_width} "
                f"(need {xy_shared_bytes(cfg.source_width, cfg.reduced_width)}"
                f" bytes of shared memory per segment_reduce_xy block, at "
                f"most {MAX_SHARED_BYTES}); use sampler='sat' or 'auto'"
            )
        self.sampler = sampler

    # -- the SAT pair -----------------------------------------------------

    def build_sat(self, frame):
        """(H, W, 3) uint8 -> (3, H, W) uint32 SAT."""
        return build_sat(frame)

    def sample(self, sat, center):
        return sample_rect_from_sat(sat, self.grid, center, wrap_x=self.wrap_x)

    def sample_chw(self, sat, center):
        return sample_rect_from_sat(
            sat, self.grid, center, wrap_x=self.wrap_x, out_layout="chw"
        )

    # -- single gaze ------------------------------------------------------

    def foveate(self, frame, center):
        if self.sampler == "sat":
            return self.sample(build_sat(frame), center)
        if self.sampler == "direct":
            return sample_rect_direct(
                frame, self.grid, center, wrap_x=self.wrap_x, in_layout="hwc"
            )
        return sample_rect_fused(
            frame, self.grid, center, wrap_x=self.wrap_x, in_layout="hwc"
        )

    def foveate_chw(self, frame, center):
        if self.sampler == "sat":
            return self.sample_chw(build_sat(frame, in_layout="chw"), center)
        if self.sampler == "direct":
            return sample_rect_direct(
                frame, self.grid, center, wrap_x=self.wrap_x, out_layout="chw"
            )
        return sample_rect_fused(
            frame, self.grid, center, wrap_x=self.wrap_x, out_layout="chw"
        )

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
        """``precision="auto"``: the fused unwarp where its contract holds
        (<= 1 LSB of exact, fovea bit-exact), the exact one elsewhere."""
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

    def sample_batch(self, sat, centers):
        """One SAT + (N, 2) centres -> (N, Hr, Wr, 3)."""
        return self.sample(sat, centers)

    def foveate_batch(self, frame, centers):
        """(H, W, 3) frame, one SAT, (N, 2) centres -> (N, Hr, Wr, 3)."""
        return self.sample_batch(build_sat(frame), centers)

    def roundtrip_batch(self, frame, centers):
        """One SAT, N gazes: ((N, Hr, Wr, 3), (N, H, W, 3)), each gaze's
        reduced frame and its exact unwarp."""
        reduced = self.foveate_batch(frame, centers)
        restored = torch.stack(
            [self.unwarp(r, c) for r, c in zip(reduced, centers)]
        )
        return reduced, restored

    def sample_batch_fused(self, frame, centers):
        """(H, W, 3) frame + (N, 2) centres -> (N, Hr, Wr, 3)."""
        return sample_rect_fused_batch(
            frame, self.grid, centers, wrap_x=self.wrap_x, in_layout="hwc"
        )

    def sample_batch_direct(self, frame, centers):
        """(H, W, 3) frame + (N, 2) centres -> (N, Hr, Wr, 3), no SAT."""
        return sample_rect_direct_batch(
            frame, self.grid, centers, wrap_x=self.wrap_x, in_layout="hwc"
        )

    def batch_pair(self, batch_sampler: str = "auto"):
        """The serve tick's device pair ``(prepare, sample_batch)``:
        ``prepare(frame_hwc)`` once per source frame,
        ``sample_batch(prepared, centers)`` once per member batch.  "sat"
        builds one SAT per frame for the whole batch; "fused" and "direct"
        need no prepare stage; "auto" is fused where the shape is eligible
        and "sat" otherwise."""
        _check_sampler(batch_sampler)
        if batch_sampler == "auto":
            batch_sampler = "fused" if self.fused_ok else "sat"
        if batch_sampler == "sat":
            return self.build_sat, self.sample_batch
        if batch_sampler == "direct":
            return _identity, self.sample_batch_direct
        return _identity, self.sample_batch_fused

    def single_pair(self):
        """(prepare, sample) for the single-session serve loop: the SAT
        pair when the resolved sampler is "sat" (prepare the SAT eagerly,
        sample at the gaze-late tick), else (stage, foveate): the fused and
        direct samplers have no gaze-independent prepare stage."""
        if self.sampler == "sat":
            return self.build_sat, self.sample
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


def default_pipeline(device: str | torch.device | None = None) -> FoveationPipeline:
    """The pipeline of the default :class:`FoveaxConfig` on ``device``
    (``cuda`` unless told otherwise), built once per device."""
    return _default_pipeline(resolve_device(device))


@functools.lru_cache(maxsize=8)
def _default_pipeline(device: torch.device) -> FoveationPipeline:
    return FoveationPipeline(device=device)
