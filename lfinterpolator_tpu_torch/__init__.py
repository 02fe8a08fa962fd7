"""lfinterpolator_tpu_torch — the light-field interpolator on PyTorch + CUDA.

The port of ``lfinterpolator_tpu`` (JAX/Pallas) to PyTorch, with the JAX
package's Pallas kernels rewritten by hand in CUDA C++ for Hopper (H100).
Load a camera-grid light field, then synthesize 64 novel views along a
trajectory by shift-and-sum weighted blending, at a fixed focus or all in
focus (a per-pixel focus map from a disparity search). The rest of the JAX
package's surface follows slice by slice (ROADMAP.md).

Importing the package imports neither jax nor torch's CUDA runtime, and
builds nothing: the kernels compile at first use (``ops/_build.py``).
"""

from lfinterpolator_tpu.core.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Interpolator",
    "RenderResult",
    "interpolate",
    "__version__",
]

_LAZY = {
    "Interpolator": ("lfinterpolator_tpu_torch.api", "Interpolator"),
    "RenderResult": ("lfinterpolator_tpu_torch.api", "RenderResult"),
    "interpolate": ("lfinterpolator_tpu_torch.api", "interpolate"),
}


def __getattr__(name):
    """Lazy top-level exports (importing the package stays light)."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
