"""Central configuration: the port's own copy of ``foveax/config.py``.

The reference scatters its knobs across compile-time defines and hardcoded
paths (reference: src/parameters.h:3-12, src/constants.h:3,
src/video_server.cc:53, src/video_client.cc:117,191).  The port keeps the
same dataclass with the reference values as defaults; it imports nothing
from the JAX package.
"""

from __future__ import annotations

import dataclasses


def reduced_dim(dim: int, scale: float = 1.8, multiple: int = 16) -> int:
    """Reduced-size rule of the reference's offline experiments,
    ``16*ceil(dim/1.8/16)`` (reference:
    src/run_satlogrectilinear.cc:113-114,368-369)."""
    return multiple * (-(-int(dim / scale) // multiple))


@dataclasses.dataclass(frozen=True)
class FoveaxConfig:
    # Transport (reference: src/parameters.h:3-7)
    server_port: int = 9562
    server_port_2: int = 9563

    # Foveated (transmitted) frame size (reference: src/parameters.h:8-9)
    reduced_width: int = 1072
    reduced_height: int = 608

    # Source video assumptions (reference: src/video_client.h:65-66)
    source_width: int = 1920
    source_height: int = 1080

    # Server pacing (reference: src/video_server.cc:314)
    fps: float = 30.0

    # Client UI loop floor, ms (reference: src/video_client.h:60)
    client_loop_floor_ms: float = 5.0

    # Encoder settings (reference: src/video_encoder.cc:22-58)
    bitrate: int = 100_000_000
    gop_size: int = 30
    max_b_frames: int = 0

    # SVD-compressed SAT rank (reference: src/eigen_sat_generate.cc:12)
    svd_rank: int = 30

    # Log-polar exponent alpha (reference:
    # src/image_sampler_sample_logpolar_kernel.cl:3)
    logpolar_alpha: float = 1.0

    # Gnomonic viewport FOV scale (reference: src/projections_program.cl:20)
    gnomonic_scale: tuple[float, float] = (6.0, 3.0)

    @property
    def reduced_size(self) -> tuple[int, int]:
        return (self.reduced_width, self.reduced_height)

    @property
    def source_size(self) -> tuple[int, int]:
        return (self.source_width, self.source_height)

    def with_source(self, width: int, height: int) -> "FoveaxConfig":
        """Config for a given source resolution with the reduced-size rule."""
        return dataclasses.replace(
            self,
            source_width=width,
            source_height=height,
            reduced_width=reduced_dim(width),
            reduced_height=reduced_dim(height),
        )


DEFAULT_CONFIG = FoveaxConfig()
