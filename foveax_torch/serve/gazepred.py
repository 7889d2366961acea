"""Gaze prediction: hide one frame of gaze-to-photon latency.

The server applies the latest gaze at the next 30 fps tick (reference:
src/video_server.cc:325-328), so the frame a client sees was sampled at a
gaze one tick old.  A predictor extrapolates the gaze to the next tick.
The 360_em dataset's own ``pred_*`` fields model exactly this one-frame
lag (reference: src/gaze_view_points.cc:25-31 — they carry the PREVIOUS
frame's value, a zero-order hold).

Three predictors, evaluated against traces by :func:`evaluate_predictors`:

  * ``zero``   — hold the latest gaze (the reference's behavior).
  * ``linear`` — one-MESSAGE-step extrapolation from the last two gazes
    (kept step-based for back-compat — it doubles the
    last inter-message delta, whatever the message rate).
  * ``kalman`` — per-axis constant-velocity Kalman filter with
    saccade-aware reset and REAL-TIME dynamics: updates carry
    timestamps (velocity is units/second, process noise scales with
    dt), and ``predict(horizon_s)`` extrapolates by the server's actual
    tick length.  This matters because clients send frameRequests at
    their own rate (the browser viewer ~200 Hz mousemoves, the headless
    client per received frame) — a per-message-step filter would shrink
    the prediction horizon to the message interval and hide nothing.
    Eye movement alternates smooth pursuit (where filtering the velocity
    beats raw differencing) and ballistic saccades (where extrapolating
    the OLD motion is wrong — a large innovation resets the filter to
    the measurement with zero velocity, so post-saccade frames do not
    overshoot).

The x axis lives on the 360-degree seam: all differences/innovations use
the wrap-shortest delta, and positions are kept in [0, 1) mod 1.
"""

from __future__ import annotations

import time

import numpy as np


def _wrap_delta(a: float, b: float) -> float:
    """Shortest signed delta a - b on the unit circle."""
    d = a - b
    if d > 0.5:
        d -= 1.0
    elif d < -0.5:
        d += 1.0
    return d


class ZeroPredictor:
    """Hold the latest gaze (the reference server's behavior)."""

    def update(self, cx: float, cy: float, t: float | None = None) -> None:
        self.c = (cx, cy)

    def predict(self, horizon_s: float = 1 / 30) -> tuple[float, float]:
        return getattr(self, "c", (0.5, 0.5))


class LinearPredictor:
    """One-step extrapolation from the last two gazes (x wraps)."""

    def __init__(self):
        self.prev = (0.5, 0.5)
        self.cur = (0.5, 0.5)

    def update(self, cx: float, cy: float, t: float | None = None) -> None:
        self.prev = self.cur
        self.cur = (cx, cy)

    def predict(self, horizon_s: float = 1 / 30) -> tuple[float, float]:
        cx, cy = self.cur
        dx = _wrap_delta(cx, self.prev[0])
        nx = (cx + dx) % 1.0
        ny = min(max(cy + (cy - self.prev[1]), 0.0), 1.0)
        return (nx, ny)


class _Kalman1D:
    """Constant-velocity Kalman filter on one axis (optionally circular).

    State [position (units), velocity (units/second)].  Updates carry a
    timestamp; F = [[1, dt], [0, 1]] with piecewise-white-acceleration
    process noise scaled by dt, so irregular message rates (mouse-rate
    frameRequests vs per-frame) produce the same filtered trajectory.
    Defaults tuned for normalized gaze units: measurement noise ~
    mouse/eye-tracker jitter, process noise ~ pursuit acceleration.
    """

    # dt clamps: messages inside one ~ms burst are treated as 1 ms apart
    # (a zero dt would make the velocity unobservable); gaps beyond 0.5 s
    # carry no useful velocity evidence.
    DT_MIN, DT_MAX = 1e-3, 0.5

    def __init__(self, wrap: bool, q: float = 0.04, r: float = 4e-4,
                 saccade: float = 0.08):
        self.wrap = wrap
        self.q, self.r = q, r
        self.saccade = saccade
        self.x = np.array([0.5, 0.0])
        self.p = np.diag([1.0, 1.0])
        self._seen = False
        self._t = 0.0

    def _norm(self, v: float) -> float:
        return v % 1.0 if self.wrap else min(max(v, 0.0), 1.0)

    def update(self, z: float, t: float) -> None:
        if not self._seen:
            self._seen = True
            self.x = np.array([z, 0.0])
            self.p = np.diag([self.r, 1.0])
            self._t = t
            return
        dt = min(max(t - self._t, self.DT_MIN), self.DT_MAX)
        self._t = t
        # Predict.
        f = np.array([[1.0, dt], [0.0, 1.0]])
        x = f @ self.x
        x[0] = self._norm(x[0])
        # Piecewise-white-acceleration process noise over dt.
        qm = self.q * np.array(
            [[0.25 * dt**4, 0.5 * dt**3], [0.5 * dt**3, dt**2]]
        )
        p = f @ self.p @ f.T + qm

        innov = _wrap_delta(z, x[0]) if self.wrap else z - x[0]
        if abs(innov) > self.saccade:
            # Ballistic saccade: the pursuit model is invalid — restart at
            # the measurement with zero velocity and loose covariance.
            self.x = np.array([z, 0.0])
            self.p = np.diag([self.r, 1.0])
            return
        s = p[0, 0] + self.r
        k = p[:, 0] / s
        self.x = x + k * innov
        self.x[0] = self._norm(self.x[0])
        self.p = p - np.outer(k, p[0, :])

    def predict(self, horizon_s: float) -> float:
        return self._norm(self.x[0] + self.x[1] * horizon_s)


class KalmanPredictor:
    """Saccade-aware constant-velocity Kalman, per axis (x circular)."""

    def __init__(self):
        self.kx = _Kalman1D(wrap=True)
        self.ky = _Kalman1D(wrap=False)

    def update(self, cx: float, cy: float, t: float | None = None) -> None:
        if t is None:
            t = time.monotonic()
        self.kx.update(cx, t)
        self.ky.update(cy, t)

    def predict(self, horizon_s: float = 1 / 30) -> tuple[float, float]:
        return (self.kx.predict(horizon_s), self.ky.predict(horizon_s))


_MODES = {"zero": ZeroPredictor, "linear": LinearPredictor, "kalman": KalmanPredictor}


def make_predictor(mode: str):
    if mode not in _MODES:
        raise ValueError(f"unknown gaze predictor {mode!r}")
    return _MODES[mode]()


def evaluate_predictors(
    gazes: np.ndarray,
    modes=("zero", "linear", "kalman"),
    fps: float = 30.0,
):
    """Mean wrap-aware prediction error (normalized units) of each mode
    over a (N, 2) gaze trace sampled at ``fps``: at step i the predictor
    has seen gazes [0..i] and is scored against gaze i+1 — the one-tick
    latency the serving loop actually hides."""
    gazes = np.asarray(gazes, dtype=np.float64)
    dt = 1.0 / fps
    out = {}
    for mode in modes:
        p = make_predictor(mode)
        errs = []
        for i in range(len(gazes) - 1):
            p.update(gazes[i][0], gazes[i][1], t=i * dt)
            px, py = p.predict(dt)
            tx, ty = gazes[i + 1]
            errs.append(float(np.hypot(_wrap_delta(px, tx), py - ty)))
        out[mode] = float(np.mean(errs)) if errs else 0.0
    return out
