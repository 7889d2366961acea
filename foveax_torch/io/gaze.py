"""Gaze-trace parsing for the 360_em_dataset reformatted traces.

Line format: ``frame,<N>,forward,<x>,<y>,eye,<x>,<y>`` — view point then
gaze point, both normalized [0, 1] coordinates.  Each record also carries
"predicted" points equal to the previous record's values (a one-frame-lag
predictor), matching the reference parser (reference:
src/gaze_view_points.cc:3-38, src/gaze_view_points.h:10-23).  The port's
own copy of ``foveax/io/gaze.py``: host code, the same parse and the same
synthetic trace text for the same seed.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np

_FLOAT = r"([-+]?\d*\.?\d+(?:[eE][-+]?\d+)?)"
_LINE_RE = re.compile(
    rf"frame,(\d+),forward,{_FLOAT},{_FLOAT},eye,{_FLOAT},{_FLOAT}"
)


@dataclasses.dataclass
class GazeViewPoint:
    frame: int
    view_point: tuple[float, float]
    gaze_point: tuple[float, float]
    pred_view_point: tuple[float, float]
    pred_gaze_point: tuple[float, float]


class GazeViewPoints:
    """Parsed gaze trace; ``points[i]`` follows file order (typically one
    record per video frame)."""

    def __init__(self, file_path: str | Path | None = None):
        self.points: list[GazeViewPoint] = []
        if file_path is not None:
            self._parse(Path(file_path).read_text())

    @classmethod
    def from_text(cls, text: str) -> "GazeViewPoints":
        gvp = cls()
        gvp._parse(text)
        return gvp

    def _parse(self, text: str) -> None:
        for line in text.splitlines():
            m = _LINE_RE.search(line)
            if not m:
                continue
            vp = (float(m.group(2)), float(m.group(3)))
            gp = (float(m.group(4)), float(m.group(5)))
            if self.points:
                prev = self.points[-1]
                pred_vp, pred_gp = prev.view_point, prev.gaze_point
            else:
                pred_vp, pred_gp = vp, gp
            self.points.append(
                GazeViewPoint(
                    frame=int(m.group(1)),
                    view_point=vp,
                    gaze_point=gp,
                    pred_view_point=pred_vp,
                    pred_gaze_point=pred_gp,
                )
            )

    def gaze_array(self) -> np.ndarray:
        """(N, 2) float32 gaze points, the per-frame sampling centers."""
        return np.asarray(
            [p.gaze_point for p in self.points], dtype=np.float32
        ).reshape(-1, 2)

    def gaze_for_frame(self, frame_idx: int) -> tuple[float, float]:
        """Gaze for a frame index, clamped to the trace length (the offline
        programs index ``points[frame]`` directly, reference:
        src/run_satlogrectilinear.cc:738-741)."""
        if not self.points:
            return (0.5, 0.5)
        i = min(frame_idx, len(self.points) - 1)
        return self.points[i].gaze_point

    def __len__(self) -> int:
        return len(self.points)


def synthetic_trace(n_frames: int, seed: int = 0, saccades: bool = False) -> str:
    """Generate a plausible gaze trace in the dataset's text format (for
    tests and demos): smooth pursuit, optionally interrupted by ballistic
    saccades (instant jumps to a new fixation every ~2 s) — the two
    regimes eye movement alternates between."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) / 30.0
    x = 0.5 + 0.3 * np.sin(0.7 * t) + 0.02 * rng.standard_normal(n_frames)
    y = 0.5 + 0.2 * np.cos(1.1 * t) + 0.02 * rng.standard_normal(n_frames)
    if saccades:
        offset = np.zeros((n_frames, 2))
        cur = np.zeros(2)
        for i in range(n_frames):
            if i > 0 and i % 60 == 0:
                cur = rng.uniform(-0.25, 0.25, 2)
            offset[i] = cur
        x = x + offset[:, 0]
        y = y + offset[:, 1]
    x, y = np.clip(x, 0.0, 1.0), np.clip(y, 0.0, 1.0)
    lines = [
        f"frame,{i},forward,{x[i]:.6f},{y[i]:.6f},eye,{x[i]:.6f},{y[i]:.6f}"
        for i in range(n_frames)
    ]
    return "\n".join(lines) + "\n"
