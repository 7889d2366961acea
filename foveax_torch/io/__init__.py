"""Host-side IO: video decode/encode, PNG, gaze traces, wire codecs,
fragment muxing (the port's own copies of the JAX package's jax-free
``io`` modules)."""

from foveax_torch.io.gaze import GazeViewPoint, GazeViewPoints
from foveax_torch.io.png import load_png, save_png
from foveax_torch.io.mux import FragmentReader, FragmentWriter, make_fragment_reader
from foveax_torch.io.video import (
    LoopingReader,
    SyntheticReader,
    VideoReader,
    VideoWriter,
    open_video,
    parse_synthetic_spec,
)
from foveax_torch.io.wirecodec import (
    WIRE_PRESETS,
    available_wire_codecs,
    make_wire_decoder,
    make_wire_encoder,
    pick_wire_preset,
)

__all__ = [
    "GazeViewPoint",
    "GazeViewPoints",
    "load_png",
    "save_png",
    "FragmentReader",
    "FragmentWriter",
    "LoopingReader",
    "SyntheticReader",
    "VideoReader",
    "VideoWriter",
    "WIRE_PRESETS",
    "available_wire_codecs",
    "make_fragment_reader",
    "make_wire_decoder",
    "make_wire_encoder",
    "open_video",
    "parse_synthetic_spec",
    "pick_wire_preset",
]
