"""Terminal progress bar (equivalent of the vendored loadingbar.hpp used at
reference: src/lfLoader.cpp:60-65, src/interpolator.cu:103-131); the port's
own copy of ``lfinterpolator_tpu/utils/progress.py``."""

from __future__ import annotations

import sys
import threading


class LoadingBar:
    def __init__(self, total: int, label: str = "", *, enabled: bool = True, width: int = 40):
        self.total = max(int(total), 1)
        self.count = 0
        self.width = width
        self.enabled = enabled and sys.stderr.isatty()
        self._lock = threading.Lock()
        if label and self.enabled:
            print(label, file=sys.stderr)
        self._render()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.count = min(self.count + n, self.total)
            self._render()

    def _render(self) -> None:
        if not self.enabled:
            return
        filled = self.width * self.count // self.total
        bar = "#" * filled + "-" * (self.width - filled)
        pct = 100 * self.count // self.total
        sys.stderr.write(f"\r[{bar}] {pct:3d}% ({self.count}/{self.total})")
        sys.stderr.flush()

    def finish(self) -> None:
        if self.enabled:
            self.count = self.total
            self._render()
            sys.stderr.write("\n")
            sys.stderr.flush()
