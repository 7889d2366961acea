"""Per-stage latency accounting + optional device profiler traces
(counterpart of ``foveax/pipeline/profiling.py``).

The reference's observability is ad-hoc chrono spans accumulated per phase
and printed at exit (reference: src/video_client.h:68-73,
src/video_client.cc:375-383; server pacing checkpoint
src/video_server.cc:207-208,310-318).  A StageTimer collects per-stage
counts/totals/maxima, and with ``use_torch_profiler`` it also wraps each
stage in a ``torch.profiler.record_function`` range, so that the stages
line up with the kernels in a :func:`device_trace`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from pathlib import Path


@dataclasses.dataclass
class StageStat:
    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


class StageTimer:
    def __init__(self, use_torch_profiler: bool = False):
        self.stats: dict[str, StageStat] = defaultdict(StageStat)
        self.use_torch_profiler = use_torch_profiler

    @contextlib.contextmanager
    def stage(self, name: str):
        ctx = contextlib.nullcontext()
        if self.use_torch_profiler:
            import torch.profiler

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        ms = (time.perf_counter() - t0) * 1e3
        s = self.stats[name]
        s.count += 1
        s.total_ms += ms
        s.max_ms = max(s.max_ms, ms)

    def report(self) -> str:
        lines = []
        for name in sorted(self.stats):
            s = self.stats[name]
            lines.append(
                f"{name}: n={s.count} avg={s.avg_ms:.2f}ms max={s.max_ms:.2f}ms"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            name: {"count": s.count, "avg_ms": s.avg_ms, "max_ms": s.max_ms}
            for name, s in self.stats.items()
        }


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """Profile a region with ``torch.profiler`` (host ops, and the card's
    kernels where CUDA is available) and write it to
    ``log_dir/trace.json``, a Chrome trace (chrome://tracing, Perfetto)."""
    import torch
    import torch.profiler

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
