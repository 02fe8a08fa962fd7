"""frames_per_s: 64-view results (all in focus with their two maps) that
reached the caller's host memory in the window, over the window: from its
start to the return of its last frame."""


def read(rec):
    if not rec.frames:
        return None
    return len(rec.frames) / (rec.t_end - rec.t_start)
