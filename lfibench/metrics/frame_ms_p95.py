"""frame_ms_p95: the 95th percentile (linear between ranks) of every
frame's latency in the window, in ms."""

import numpy as np


def read(rec):
    if not rec.frames:
        return None
    return 1e3 * float(np.percentile([t1 - t0 for t0, t1 in rec.frames], 95))
