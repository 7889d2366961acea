"""Sharded pipeline steps over a ``("data", "space")`` mesh (counterpart
of ``foveax/parallel/sharded.py``).

One process drives every mesh entry (``parallel/mesh.py``): a shard's work
is an ordinary call on the block that lives on its entry, and a collective
is a copy between blocks.  Nothing is traced or compiled; the ``jit_*``
names are the JAX package's, kept so that a reader finds each
counterpart, and return plain closures.

1. **Sharded SAT build** — the frame is split by image rows over
   ``space``.  Each block's local SAT is the SAT build (kernel K5 on a
   CUDA block, its plain version on the CPU); the column scan across
   blocks is then a carry: block ``s`` adds the exclusive prefix of the
   column totals (the last row) of the blocks before it, mod 2^32.  The
   totals are gathered to the first entry, the carry is an int64 cumsum
   there (:func:`_sat_carry`), and each block gets its row back.

2. **Multi-client step** — gazes are split over ``data``.  Each data shard
   needs the whole SAT to sample its clients' boxes, so the row blocks are
   gathered onto its entry; sampling and the exact unwarp then run there
   with no further copies.

**Compute only what is read.**  The JAX package's ``shard_map`` bodies run
on every mesh entry, so its outputs are replicated over ``space``; the
replicas are a consequence of SPMD, not a result.  Here space block ``s``
of the SAT is built once, on entry ``(0, s)``, and data block ``d`` of
the clients is sampled (and unwarped) once, on entry ``(d, 0)``.  Kernel
launches per call: K5 ``n_space`` for :func:`sharded_build_sat`,
:func:`multi_client_step` and :func:`jit_serve_parts`' build;
``segreduce_xy`` ``n_data`` for :func:`sharded_sample_batch_fused` and
:func:`jit_serve_parts_fused`' sample; K5 once per frame for
:func:`frame_parallel_roundtrip`.  The unwarp is ``precision="exact"``,
as the JAX package's is here, so no unwarp kernel runs.

A sharded result is a :class:`Sharded`: its per-entry blocks and the axis
it is split on.  uint32 blocks are copied and concatenated through their
int32 view (PyTorch's uint32 support is partial); the arithmetic on them
is int64, masked to 32 bits, never int32, which wraps at 2^31.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from foveax_torch.core.logrect import LogRectGrid
from foveax_torch.core.sample import sample_rect_from_sat
from foveax_torch.core.sat import build_sat
from foveax_torch.core.unwarp import unwarp_rect
from foveax_torch.kernels.scan2d import MASK32, as_int64, low32
from foveax_torch.kernels.segreduce import sample_rect_fused_batch
from foveax_torch.parallel.mesh import Mesh


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (itself if it is there already)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(device).view(torch.uint32)
    return t.to(device)


def _cat(blocks: list[torch.Tensor], dim: int) -> torch.Tensor:
    if len(blocks) == 1:
        return blocks[0]
    if blocks[0].dtype == torch.uint32:
        out = torch.cat([b.view(torch.int32) for b in blocks], dim)
        return out.view(torch.uint32)
    return torch.cat(blocks, dim)


class Sharded(NamedTuple):
    """A value split over a mesh axis: ``blocks[k]`` lives on the k-th
    entry of that axis, and the blocks concatenate along tensor dimension
    ``dim``."""

    blocks: tuple[torch.Tensor, ...]
    axis: str | tuple[str, ...]
    dim: int

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole value on ``device`` (default: the first block's)."""
        dev = self.blocks[0].device if device is None else torch.device(device)
        return _cat([_to(b, dev) for b in self.blocks], self.dim)

    def cpu(self) -> torch.Tensor:
        """The whole value on the host: the readback the server makes of
        a batch, whichever pair produced it."""
        return self.gather("cpu")


def _grid_on(grid: LogRectGrid, device: torch.device) -> LogRectGrid:
    if grid.device == device:
        return grid
    return dataclasses.replace(grid, gx=grid.gx.to(device), gy=grid.gy.to(device))


def _split(x: torch.Tensor, n: int, what: str) -> list[torch.Tensor]:
    """``x`` cut into ``n`` equal runs of its leading dimension."""
    if x.shape[0] % n:
        raise ValueError(
            f"{what}: {x.shape[0]} do not divide evenly over {n} mesh entries"
        )
    m = x.shape[0] // n
    return [x[k * m:(k + 1) * m] for k in range(n)]


def _data_entries(mesh: Mesh) -> list[torch.device]:
    """Entry ``(d, 0)`` of every data shard: where its clients run."""
    return [row[0] for row in mesh.devices]


def _replicate(frame: torch.Tensor, devices: list[torch.device]):
    """One copy of ``frame`` per entry, made once per distinct device."""
    copies: dict[torch.device, torch.Tensor] = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = frame.to(dev)
    return tuple(copies[dev] for dev in devices)


def _sat_carry(totals: torch.Tensor) -> torch.Tensor:
    """(3, n, W) int64 column totals of n row blocks, each in [0, 2^32)
    -> (3, n, W) int64 carries: for block ``s`` the sum of the totals of
    blocks ``0 .. s-1``, mod 2^32 (block 0 gets 0)."""
    return (totals.cumsum(1) - totals) & MASK32


def _local_sat_block(frame_block: torch.Tensor) -> torch.Tensor:
    """A (h, W, 3) uint8 row block -> its own (3, h, W) uint32 SAT: K5 on
    a CUDA block.  The carry from the blocks above is added later."""
    return build_sat(frame_block)


def sharded_build_sat(frame: torch.Tensor, mesh: Mesh) -> Sharded:
    """(H, W, 3) uint8 -> the (3, H, W) uint32 SAT, row-sharded over
    ``space``: block ``s`` on entry ``(0, s)``.  H must divide evenly by
    the mesh's space size."""
    devices = mesh.devices[0]
    local = [
        _local_sat_block(block.to(dev))
        for block, dev in zip(_split(frame, len(devices), "frame rows"), devices)
    ]
    home = devices[0]
    totals = torch.stack([as_int64(_to(b[:, -1], home)) for b in local], 1)
    carry = _sat_carry(totals)
    blocks = tuple(
        low32(as_int64(b) + carry[:, s, None, :].to(b.device))
        for s, b in enumerate(local)
    )
    return Sharded(blocks, "space", 1)


def sharded_sample_batch(
    sat: Sharded,
    centers: torch.Tensor,
    grid: LogRectGrid,
    mesh: Mesh,
) -> Sharded:
    """Gaze-late half of the sharded serving step: sample a batch of
    client gazes from a row-sharded SAT.

    ``sat``: the (3, H, W) uint32 SAT row-sharded over ``space`` (the
    output of :func:`sharded_build_sat`).  ``centers``: (N, 2)
    float32, N divisible by the data-axis size.  Each data shard gathers
    the SAT onto its entry (once per distinct device) and samples its
    clients there.  Returns the (N, Hr, Wr, 3) uint8 batch sharded over
    ``data``."""
    entries = _data_entries(mesh)
    full: dict[torch.device, torch.Tensor] = {}
    blocks = []
    for dev, c in zip(entries, _split(centers, len(entries), "centers")):
        if dev not in full:
            full[dev] = sat.gather(dev)
        blocks.append(sample_rect_from_sat(full[dev], _grid_on(grid, dev), c.to(dev)))
    return Sharded(tuple(blocks), "data", 0)


def multi_client_step(
    frame: torch.Tensor,
    centers: torch.Tensor,
    grid: LogRectGrid,
    mesh: Mesh,
    *,
    unwarp: bool = True,
):
    """Full sharded serving step: one frame, a batch of client gazes.

    ``frame``: (H, W, 3) uint8, its rows split over ``space``.
    ``centers``: (N, 2) float32, split over ``data``; N must divide by the
    data-axis size.  Returns the per-client reduced frames (N, Hr, Wr, 3)
    and, if ``unwarp``, the restored frames (N, H, W, 3) (the exact
    unwarp), each a :class:`Sharded` over ``data``.
    """
    sh, sw = frame.shape[0], frame.shape[1]
    reduced = sharded_sample_batch(sharded_build_sat(frame, mesh), centers, grid, mesh)
    if not unwarp:
        return (reduced,)
    restored = tuple(
        torch.stack([unwarp_rect(r, sw, sh, c) for r, c in zip(block, cs.to(block.device))])
        for block, cs in zip(reduced.blocks, _split(centers, len(reduced.blocks), "centers"))
    )
    return reduced, Sharded(restored, "data", 0)


def frame_parallel_roundtrip(
    frames: torch.Tensor,
    centers: torch.Tensor,
    grid: LogRectGrid,
    mesh: Mesh,
):
    """Offline transcode parallelism: a batch of frames split across ALL
    mesh entries (``(data, space)`` row-major), each foveated through its
    SAT and unwarped (exact) at its own gaze on the entry it lands on.

    ``frames``: (B, H, W, 3) uint8, B divisible by the mesh size.
    Returns (B, Hr, Wr, 3) reduced and (B, H, W, 3) restored frames, each
    a :class:`Sharded` over ``("data", "space")``.
    """
    _, sh, sw, _ = frames.shape
    n = mesh.size
    reduced, restored = [], []
    for dev, fs, cs in zip(
        mesh.flat(), _split(frames, n, "frames"), _split(centers, n, "centers")
    ):
        g = _grid_on(grid, dev)
        fs, cs = fs.to(dev), cs.to(dev)
        red = [sample_rect_from_sat(build_sat(f), g, c) for f, c in zip(fs, cs)]
        reduced.append(torch.stack(red))
        restored.append(torch.stack([unwarp_rect(r, sw, sh, c) for r, c in zip(red, cs)]))
    spec = ("data", "space")
    return Sharded(tuple(reduced), spec, 0), Sharded(tuple(restored), spec, 0)


def jit_multi_client_step(grid: LogRectGrid, mesh: Mesh, *, unwarp: bool = True):
    """``fn(frame, centers)``: :func:`multi_client_step` over (grid, mesh)
    for the serving hot loop (a plain closure; nothing is compiled)."""

    def fn(frame, centers):
        return multi_client_step(frame, centers, grid, mesh, unwarp=unwarp)

    return fn


def sharded_sample_batch_fused(
    frame: torch.Tensor | tuple[torch.Tensor, ...],
    centers: torch.Tensor,
    grid: LogRectGrid,
    mesh: Mesh,
    *,
    wrap_x: bool = True,
) -> Sharded:
    """SAT-free fused sampling of a gaze batch, sharded over ``data``.

    ``frame``: (H, W, 3) uint8, copied once to each data shard's entry,
    or the per-shard copies that :func:`jit_serve_parts_fused`' prepare
    made.  ``centers``: (N, 2) float32, N divisible by the data-axis size;
    each data shard runs the fused sampler (``segreduce_xy`` on the card,
    one launch) on its own gazes with no copy of the SAT (there is none).
    Returns the (N, Hr, Wr, 3) uint8 batch sharded over ``data``.  The
    shape must be inside the fused sampler's contract
    (:func:`foveax_torch.kernels.segreduce.fused_eligible`); the serve
    loop's ``"auto"`` takes the SAT pair otherwise.
    """
    entries = _data_entries(mesh)
    copies = frame if isinstance(frame, tuple) else _replicate(frame, entries)
    blocks = tuple(
        sample_rect_fused_batch(
            f, _grid_on(grid, dev), c.to(dev), wrap_x=wrap_x, in_layout="hwc"
        )
        for dev, f, c in zip(entries, copies, _split(centers, len(entries), "centers"))
    )
    return Sharded(blocks, "data", 0)


def jit_serve_parts(grid: LogRectGrid, mesh: Mesh):
    """``(build_fn, sample_fn)`` for the sharded broadcast serving loop,
    with the calling shape of ``FoveationPipeline.batch_pair``:
    ``build_fn(frame)`` -> the row-sharded SAT (gaze-early),
    ``sample_fn(sat, centers)`` -> the clients' reduced frames sharded
    over ``data`` (gaze-late)."""

    def build(frame):
        return sharded_build_sat(frame, mesh)

    def sample(sat, centers):
        return sharded_sample_batch(sat, centers, grid, mesh)

    return build, sample


def jit_serve_parts_fused(grid: LogRectGrid, mesh: Mesh, *, wrap_x: bool = True):
    """SAT-free ``(prepare_fn, sample_fn)`` for the sharded broadcast loop:
    ``prepare_fn(frame)`` copies the frame to every data shard's entry
    (the fused path's once-per-frame copy, paid gaze-early, so the
    gaze-late half copies nothing) and ``sample_fn(copies, centers)`` runs
    :func:`sharded_sample_batch_fused`.  Same calling shape as
    :func:`jit_serve_parts`, so the serve loop swaps pairs without
    branching per tick."""
    entries = _data_entries(mesh)

    def prepare(frame):
        return _replicate(frame, entries)

    def sample(copies, centers):
        return sharded_sample_batch_fused(copies, centers, grid, mesh, wrap_x=wrap_x)

    return prepare, sample
