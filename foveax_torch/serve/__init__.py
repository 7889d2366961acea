"""Streaming server and client on the port's pipeline (the port's fork of
the JAX package's ``serve``)."""

from foveax_torch.serve.protocol import Ack, FrameMeta, FrameRequest, TextMessage, VideoRequest
from foveax_torch.serve.server import FoveaxServer
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
