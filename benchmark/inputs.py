"""The one generator of the benchmark's inputs: every traffic mix is a data
file (``traffic/<mix>.json``) of parameters that this module reads.

From ``--seed`` it makes, the same for the same seed:

- the gaze trace: ``(steps, viewers, 2)`` float32 centres in [0, 1), one
  row per 30 Hz step.  Each viewer fixates for a span drawn from
  ``fixation_ms``, drifting by ``drift`` (a fraction of the frame) every
  step, then saccades to a new target over ``saccade_steps`` steps.  A
  target's latitude lies in ``band`` a share ``band_share`` of the time
  and in ``lat_range`` otherwise; its longitude is uniform and a saccade
  takes the short way round, across the wrap seam where that is shorter.
  The model follows the 360_em_dataset gaze traces the upstream project
  replays (src/gaze_view_points.cc).  A run loops over the trace.
- the input pool: ``pool`` seeded uint8 frames on the host, made on the
  device with a ``torch.Generator`` in one call and copied back, as a
  decoder hands frames over.  ``frames`` says which shape:
  ``"source"`` (H, W, 3) frames for a server tick, ``"reduced"`` (Hr, Wr,
  3) frames for a client's restore.
- the sampler of the units that are checked: Vitter's algorithm L, a
  uniform sample of ``check_units`` of however many units the window
  completes, at a few random draws in all.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """Any whole number, negative or past 64 bits included."""
    return np.random.SeedSequence(seed % 2**64)


def gaze_trace(rng: np.random.Generator, viewers: int, p: dict) -> np.ndarray:
    """(steps, viewers, 2) float32 gazes in [0, 1) (module docstring)."""
    steps = int(p["trace_steps"])
    hz = float(p["step_hz"])
    f_lo, f_hi = p["fixation_ms"]
    s_lo, s_hi = p["saccade_steps"]
    band, lat = p["band"], p["lat_range"]
    drift = float(p["drift"])
    out = np.empty((steps, viewers, 2), dtype=np.float64)

    def target():
        y = rng.uniform(*band) if rng.random() < p["band_share"] else rng.uniform(*lat)
        return rng.random(), y

    for v in range(viewers):
        x, y = target()
        t = 0
        while t < steps:
            n = max(1, round(rng.uniform(f_lo, f_hi) * hz / 1000.0))
            walk = np.cumsum(rng.normal(0.0, drift, size=(n, 2)), axis=0)
            n = min(n, steps - t)
            out[t:t + n, v, 0] = x + walk[:n, 0]
            out[t:t + n, v, 1] = y + walk[:n, 1]
            t += n
            x0, y0 = out[t - 1, v]
            x, y = target()
            dx = (x - x0 + 0.5) % 1.0 - 0.5
            k = int(rng.integers(s_lo, s_hi + 1))
            for i in range(1, k + 1):
                if t >= steps:
                    break
                out[t, v] = (x0 + dx * i / k, y0 + (y - y0) * i / k)
                t += 1
    out[..., 0] %= 1.0
    out[..., 1] = np.clip(out[..., 1], lat[0], lat[1])
    g = out.astype(np.float32)
    g[g >= 1.0] = 0.0  # a float64 just under 1 rounds to 1.0 in float32
    return g


def frame_pool(seed_state: np.random.SeedSequence, n: int, shape, device) -> list[np.ndarray]:
    """``n`` seeded uint8 host frames of ``shape``, made on ``device`` in
    one call and copied to pageable host memory."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_state.generate_state(1, np.uint64)[0]) & (2**63 - 1))
    frames = torch.randint(0, 256, (n, *shape), dtype=torch.uint8, device=device, generator=gen)
    host = frames.cpu().numpy()
    return [np.ascontiguousarray(host[i]) for i in range(n)]


class Inputs:
    """Everything a run feeds the program, from the seed."""

    def __init__(self, seed: int, config: dict, traffic: dict, device):
        gaze_ss, pool_ss, check_ss = seed_sequence(seed).spawn(3)
        self.viewers = int(traffic["viewers"])
        self.gazes = gaze_trace(np.random.default_rng(gaze_ss), self.viewers, traffic["gaze"])
        if traffic["frames"] == "source":
            shape = (config["source_height"], config["source_width"], 3)
        elif traffic["frames"] == "reduced":
            shape = (config["reduced_height"], config["reduced_width"], 3)
        else:
            raise ValueError(f"frames {traffic['frames']!r}: expected 'source' or 'reduced'")
        self.pool = frame_pool(pool_ss, int(traffic["pool"]), shape, device)
        self.check_rng = np.random.default_rng(check_ss)

    def gaze(self, k: int) -> np.ndarray:
        """The (viewers, 2) float32 gazes of unit ``k``."""
        return self.gazes[k % len(self.gazes)]

    def frame(self, k: int) -> int:
        """The pool index unit ``k`` uses."""
        return k % len(self.pool)

    @property
    def pool_bytes(self) -> int:
        return sum(f.nbytes for f in self.pool)


class Reservoir:
    """A uniform sample of ``size`` of the items offered, in any number
    (Vitter's algorithm L): a few random draws for the whole stream."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size = size
        self.rng = rng
        self.items: list = []
        self.seen = 0
        self._w = math.exp(math.log(self._u()) / size)
        self._next = size + self._skip()

    def _u(self) -> float:
        return float(self.rng.random()) or 1e-300

    def _skip(self) -> int:
        return int(math.floor(math.log(self._u()) / math.log1p(-self._w)))

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        elif self.seen == self._next:
            self.items[int(self.rng.integers(self.size))] = item
            self._w *= math.exp(math.log(self._u()) / self.size)
            self._next += self._skip() + 1
        self.seen += 1
