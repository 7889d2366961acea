"""Device meshes (counterpart of ``foveax/parallel/mesh.py``).

Axes:
  ``space``  — spatial (image-row) sharding for the SAT scan: the 2-D
               prefix scan's scan axis.
  ``data``   — client/gaze data parallelism: N concurrent viewers of one
               video, each with their own gaze.

One process drives the whole grid, as the JAX package's single controller
does: a :class:`Mesh` is an ``(n_data, n_space)`` grid of ``torch.device``
entries, each shard's work is an ordinary call on the block that lives on
its entry, and the collectives are copies between blocks
(``foveax_torch/parallel/sharded.py``).  No ``torch.distributed`` rank is
involved.  An entry may repeat: every entry ``cpu`` (the tests) or every
entry ``cuda:0`` (one card) runs the same decomposition on one device.
"""

from __future__ import annotations

import torch

from foveax_torch.device import resolve_device

AXIS_NAMES = ("data", "space")


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` names the current card: give it its index, so that an entry
    compares equal to the device of the tensors placed on it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An ``(n_data, n_space)`` grid of devices over the axes
    ``("data", "space")``."""

    axis_names = AXIS_NAMES

    def __init__(self, devices):
        rows = [[_indexed(resolve_device(d)) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices: tuple[tuple[torch.device, ...], ...] = tuple(
            tuple(row) for row in rows
        )

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "space": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def flat(self) -> list[torch.device]:
        """The entries in ``(data, space)`` row-major order: the order in
        which a batch split over both axes is laid out."""
        return [d for row in self.devices for d in row]


def make_mesh(
    n_space: int | None = None,
    n_data: int = 1,
    *,
    devices: list | None = None,
) -> Mesh:
    """A ``(n_data, n_space)`` mesh over the first ``n_data * n_space`` of
    ``devices``, data-major.  ``devices=None`` means every visible CUDA
    device (raises without a GPU: there is no CPU fallback); an explicit
    list may repeat a device.  ``n_space=None`` takes every device."""
    if devices is None:
        resolve_device("cuda")
        devices = [
            torch.device("cuda", k) for k in range(torch.cuda.device_count())
        ]
    if n_space is None:
        n_space = len(devices) // n_data
    n = n_space * n_data
    if n_space < 1 or n_data < 1 or len(devices) < n:
        raise ValueError(
            f"a {n_data}x{n_space} mesh needs {max(n, 1)} devices, have "
            f"{len(devices)}"
        )
    return Mesh(
        [devices[d * n_space:(d + 1) * n_space] for d in range(n_data)]
    )
