"""Share of the traced window in which no kernel, copy or set ran on the
card: 1 - (union of the device intervals) / (window seconds)."""


def read(w):
    if not w.window_s or not (w.kernels or w.copies):
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
