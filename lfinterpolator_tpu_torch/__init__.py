"""lfinterpolator_tpu_torch — the light-field interpolator on PyTorch + CUDA.

The port of ``lfinterpolator_tpu`` (JAX/Pallas) to PyTorch, with the JAX
package's Pallas kernels rewritten by hand in CUDA C++ for Hopper (H100).
Load a camera-grid light field, then synthesize 64 novel views along a
trajectory by shift-and-sum weighted blending, at a fixed focus or all in
focus (a per-pixel focus map from a disparity search, exact or
coarse-to-fine), as PNGs or as a Looking Glass quilt; several
trajectories at once (``Interpolator.interpolate_batch``), renders larger
than device memory in view batches, and video light fields frame by frame
(``StreamingRenderer``). Meshes follow (ROADMAP.md). The package imports
nothing of the JAX package: it keeps its own copies of the framework-free
modules it needs (``core/``, ``io/``, ``utils/progress.py``).

Importing the package imports neither jax nor torch's CUDA runtime, and
builds nothing: the kernels compile at first use (``ops/_build.py``).
"""

from .core.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Interpolator",
    "RenderResult",
    "QuiltResult",
    "interpolate",
    "StreamingRenderer",
    "__version__",
]

_LAZY = {
    "Interpolator": ("lfinterpolator_tpu_torch.api", "Interpolator"),
    "RenderResult": ("lfinterpolator_tpu_torch.api", "RenderResult"),
    "QuiltResult": ("lfinterpolator_tpu_torch.api", "QuiltResult"),
    "interpolate": ("lfinterpolator_tpu_torch.api", "interpolate"),
    "StreamingRenderer": ("lfinterpolator_tpu_torch.streaming", "StreamingRenderer"),
}


def __getattr__(name):
    """Lazy top-level exports (importing the package stays light)."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
