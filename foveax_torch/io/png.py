"""PNG save/load — the visual-debugging backbone (the reference does this
through FFmpeg's PNG codec, reference: src/save_frame.h:15-135).  The
port's own copy of ``foveax/io/png.py``: OpenCV's imcodecs, falling back
to PIL."""

from __future__ import annotations

from pathlib import Path

import numpy as np

try:
    import cv2

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False


def save_png(path: str | Path, frame: np.ndarray) -> None:
    """Save an (H, W, 3) RGB uint8 frame as PNG."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {frame.shape} {frame.dtype}")
    path = str(path)
    if _HAVE_CV2:
        ok = cv2.imwrite(path, frame[:, :, ::-1])
        if not ok:
            raise IOError(f"cv2.imwrite failed for {path}")
    else:  # pragma: no cover
        from PIL import Image

        Image.fromarray(frame).save(path)


def load_png(path: str | Path) -> np.ndarray:
    """Load a PNG as (H, W, 3) RGB uint8."""
    path = str(path)
    if _HAVE_CV2:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise IOError(f"cv2.imread failed for {path}")
        return bgr[:, :, ::-1].copy()
    else:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
