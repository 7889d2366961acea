"""Wire protocol: JSON text messages interleaved with binary fMP4 fragments.

Message vocabulary mirrors the reference exactly (reference:
src/video_server.cc:102-117 dispatch, :166-185 frameRequest/ack,
:396-401 image metadata; client side src/video_client.cc:63-74,125-146):

  client -> server:
    {"type": "text", "message": str}
    {"type": "videoRequest", "video": str}
    {"type": "frameRequest", "centerX": float, "centerY": float,
     "packetNumber": int}
  server -> client:
    {"type": "text", "message": str}
    {"type": "ack", "packetNumber": int}
    {"type": "image", "centerX": float, "centerY": float, "frameNum": int}
    <binary websocket frame: one fMP4 fragment (header first)>

frameNum wraps modulo 256 (reference: src/video_server.cc:397-402); the
image metadata echoes the gaze actually used so the client can unwarp with
the matching center.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


@dataclasses.dataclass
class TextMessage:
    message: str
    type: str = "text"


@dataclasses.dataclass
class VideoRequest:
    video: str
    type: str = "videoRequest"


@dataclasses.dataclass
class FrameRequest:
    centerX: float
    centerY: float
    packetNumber: int
    type: str = "frameRequest"


@dataclasses.dataclass
class Ack:
    packetNumber: int
    type: str = "ack"


@dataclasses.dataclass
class FrameMeta:
    centerX: float
    centerY: float
    frameNum: int
    type: str = "image"


_BY_TYPE = {
    "text": TextMessage,
    "videoRequest": VideoRequest,
    "frameRequest": FrameRequest,
    "ack": Ack,
    "image": FrameMeta,
}


def connection_closed_errors() -> tuple[type[BaseException], ...]:
    """What a closed connection raises: ``ConnectionError`` (an in-memory
    or socket transport), and the connection-closed exception of
    ``websockets`` where it is installed."""
    try:
        import websockets
    except ImportError:
        return (ConnectionError,)
    return (ConnectionError, websockets.ConnectionClosed)


def dumps(msg: Any) -> str:
    return json.dumps(dataclasses.asdict(msg))


_NUMERIC_FIELDS = {"centerX": float, "centerY": float, "packetNumber": int, "frameNum": int}


def loads(payload: str):
    """Parse and validate a protocol message.

    Raises ValueError for ANYTHING malformed — wrong JSON, non-object
    payloads, unknown types, missing fields, or non-numeric coordinates —
    so callers have a single exception to treat as "bad client input".
    """
    try:
        obj = json.loads(payload)
        if not isinstance(obj, dict):
            raise ValueError(f"message is not an object: {type(obj).__name__}")
        cls = _BY_TYPE.get(obj.get("type"))
        if cls is None:
            raise ValueError(f"unknown message type: {obj.get('type')!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in obj.items():
            if k not in fields:
                continue
            conv = _NUMERIC_FIELDS.get(k)
            if conv is not None:
                v = conv(v)
                # json.loads accepts NaN/Infinity literals; non-finite
                # gaze would poison the pipeline and serialize back as
                # invalid JSON.
                if conv is float and not math.isfinite(v):
                    raise ValueError(f"non-finite value for {k}: {v}")
            kwargs[k] = v
        return cls(**kwargs)
    except ValueError:
        raise
    except Exception as e:  # json errors, TypeError from cls(**), bad casts
        raise ValueError(f"malformed message: {e}") from e
