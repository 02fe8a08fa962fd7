"""Image I/O of the port: the JAX package's codec, loader and writer.

Those modules are NumPy-only (they import no jax), so the port uses them as
they are: ``load_light_field`` decodes a ``col_row.ext`` grid into a
``LightField``, ``write_views`` writes ``00.png ... NN.png`` (each frame to
a ``.tmp`` file renamed into place), and ``decode``/``encode_png`` go
through the native libpng/libjpeg codec where it is built
(``make -C native``), else through Pillow.
"""

from __future__ import annotations

from lfinterpolator_tpu.io.codec import decode, encode_png, native_available
from lfinterpolator_tpu.io.loader import LightField, load_light_field
from lfinterpolator_tpu.io.writer import write_views

__all__ = [
    "LightField",
    "codec_name",
    "decode",
    "encode_png",
    "load_light_field",
    "write_views",
]


def codec_name() -> str:
    """"native" (the libpng/libjpeg library of ``native/``) or "pillow"."""
    return "native" if native_available() else "pillow"
