"""setup_s: from the start of the run's script to the start of the window:
imports, the kernel build where the library is stale, the scene, the
program's set-up and the warm-up calls."""


def read(rec):
    return rec.setup_s
