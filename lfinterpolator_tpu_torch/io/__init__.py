"""Image I/O of the port: its own codec, loader and writer.

Copies of the JAX package's NumPy-only ``io/{codec,loader,writer}.py``:
``load_light_field`` decodes a ``col_row.ext`` grid into a ``LightField``,
``write_views`` writes ``00.png ... NN.png`` (each frame to a ``.tmp`` file
renamed into place), ``write_quilt`` one quilt PNG, and
``decode``/``encode_png`` go through the native libpng/libjpeg codec where
it is built (``make -C native``), else through Pillow.
"""

from __future__ import annotations

from .codec import decode, encode_png, native_available
from .loader import LightField, load_light_field
from .writer import write_quilt, write_views

__all__ = [
    "LightField",
    "codec_name",
    "decode",
    "encode_png",
    "load_light_field",
    "write_quilt",
    "write_views",
]


def codec_name() -> str:
    """"native" (the libpng/libjpeg library of ``native/``) or "pillow"."""
    return "native" if native_available() else "pillow"
