"""Streaming server and client on the port's pipeline (the port's fork of
the JAX package's ``serve``).  The server module loads when
``FoveaxServer`` is first asked for, so a client alone never imports it."""

from foveax_torch.serve.protocol import Ack, FrameMeta, FrameRequest, TextMessage, VideoRequest
from foveax_torch.serve.client import FoveaxClient, ClientStats

__all__ = [
    "Ack",
    "FrameMeta",
    "FrameRequest",
    "TextMessage",
    "VideoRequest",
    "FoveaxServer",
    "FoveaxClient",
    "ClientStats",
]


def __getattr__(name: str):
    if name == "FoveaxServer":
        from foveax_torch.serve.server import FoveaxServer

        return FoveaxServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
