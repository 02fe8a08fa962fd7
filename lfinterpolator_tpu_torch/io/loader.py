"""Light-field dataset ingest.

The port's own copy of ``lfinterpolator_tpu/io/loader.py``, the equivalent
of the reference's LfLoader (reference: src/lfLoader.cpp:8-67): scan a
directory of images named ``col_row.ext``, infer the grid dimensions,
decode every image, and produce one contiguous uint8 stack ready for a
single host->device transfer.

Differences from the reference (conscious fixes, see SURVEY.md section 3.5):
  * grid dimensions come from the max coordinate over ALL filenames, not the
    lexicographically last one (the reference requires zero-padded names,
    src/lfLoader.cpp:57);
  * an image named ``a_b.ext`` is placed at (col=a, row=b) per the reference's
    own help text (src/main.cpp:17); the reference BINARY transposes storage
    in a way that is only self-consistent for square grids
    (src/lfLoader.cpp:64), so identical inputs+trajectory give transposed
    results vs the reference tool. Pass ``reference_order=True`` to reproduce
    the binary's transposed placement for side-by-side comparisons;
  * missing grid cells and mismatched resolutions raise actionable errors
    instead of crashing later.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import re

import numpy as np

from ..utils.progress import LoadingBar
from . import codec

_NAME_RE = re.compile(r"^(\d+)_(\d+)\.[^.]+$")


@dataclasses.dataclass
class LightField:
    """A decoded camera-grid light field.

    images: [G, H, W, 4] uint8 in flat order col*rows + row.
    """

    images: np.ndarray
    cols: int
    rows: int

    @property
    def grid_size(self) -> int:
        return self.cols * self.rows

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]

    @property
    def cols_rows(self) -> tuple[int, int]:
        return self.cols, self.rows

    def image(self, col: int, row: int) -> np.ndarray:
        return self.images[col * self.rows + row]


def parse_filename(name: str) -> tuple[int, int]:
    """``a_b.ext`` -> (col=a, row=b) (reference: src/lfLoader.cpp:22-31)."""
    m = _NAME_RE.match(name)
    if m is None:
        raise ValueError(
            f"File {name} is not named properly as column_row.extension!"
        )
    return int(m.group(1)), int(m.group(2))


def list_grid_files(path: str) -> dict[tuple[int, int], str]:
    """Map (col, row) -> absolute file path for every grid image in `path`."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"The path {path} does not exist!")
    if not os.path.isdir(path):
        raise NotADirectoryError(f"The path {path} does not lead to a directory!")
    entries = sorted(os.listdir(path))
    if not entries:
        raise ValueError("The input directory is empty!")
    files: dict[tuple[int, int], str] = {}
    skipped = []
    for name in entries:
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            continue
        if _NAME_RE.match(name) is None:
            # Stray files (.DS_Store, quilt.png, ...) don't abort the load of
            # an otherwise complete grid.
            skipped.append(name)
            continue
        coords = parse_filename(name)
        if coords in files:
            raise ValueError(f"Duplicate grid position {coords}: {name}")
        files[coords] = full
    if not files:
        raise ValueError(
            "No grid images found: files must be named column_row.extension "
            f"(e.g. 01_12.png). Ignored entries: {skipped[:8]}"
        )
    return files


def load_light_field(
    path: str,
    *,
    progress: bool = True,
    workers: int | None = None,
    reference_order: bool = False,
) -> LightField:
    """Load all grid images from a directory into a LightField.

    ``reference_order=True`` reproduces the reference binary's transposed
    grid placement (src/lfLoader.cpp:64 stores ``a_b.ext`` at (col=b, row=a)
    despite the help text) -- only meaningful for square grids, where it
    makes outputs directly comparable against the reference tool's.
    """
    files = list_grid_files(path)
    if reference_order:
        files = {(r, c): f for (c, r), f in files.items()}
    cols = max(c for c, _ in files) + 1
    rows = max(r for _, r in files) + 1
    missing = [
        (c, r) for c in range(cols) for r in range(rows) if (c, r) not in files
    ]
    if missing:
        raise ValueError(
            f"Incomplete {cols}x{rows} grid: missing images at positions "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}"
        )

    bar = LoadingBar(len(files), "Loading images...", enabled=progress)
    if workers is None:
        workers = min(16, os.cpu_count() or 4)

    # Decode one image to learn the resolution, then decode the rest straight
    # into the preallocated stack (avoids holding a second copy of the whole
    # dataset during assembly).
    first = codec.decode(files[(0, 0)])
    bar.add()
    h, w = first.shape[:2]
    images = np.empty((cols * rows, h, w, 4), dtype=np.uint8)

    # Fast path: one native threaded batch decode straight into the stack
    # (the reference loader's bulk ingest loop, src/lfLoader.cpp:59-66, as a
    # C++ thread pool -- no per-image Python round-trips). Restricted to the
    # formats the native codec handles; a decode failure falls back to the
    # per-image path, which can still rescue odd files via Pillow.
    slot_paths = [files[(c, r)] for c in range(cols) for r in range(rows)]
    exts = {os.path.splitext(p)[1].lower() for p in slot_paths}
    if exts <= {".png", ".jpg", ".jpeg"}:
        try:
            # slot 0 (= (0,0): the probe above) is already decoded; the
            # [1:] view of the C-contiguous stack is itself contiguous
            if codec.decode_batch(slot_paths[1:], images[1:], threads=workers):
                images[0] = first
                bar.add(len(files) - 1)
                bar.finish()
                return LightField(images=images, cols=cols, rows=rows)
        except RuntimeError:
            pass  # per-image path below (Pillow fallback per file)

    images[0] = first
    del first

    def _load(item):
        (c, r), f = item
        img = codec.decode(f)
        if img.shape[:2] != (h, w):
            raise ValueError(
                f"Image at grid position ({c},{r}) has resolution "
                f"{img.shape[1]}x{img.shape[0]}, expected {w}x{h}"
            )
        images[c * rows + r] = img
        bar.add()

    rest = [item for item in sorted(files.items()) if item[0] != (0, 0)]
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(_load, rest))
    bar.finish()
    return LightField(images=images, cols=cols, rows=rows)
