"""The median time of a guided sampling step (CUDA events at the step
boundaries, as for sample_step_ms_p95): a steadier statistic beside the
tail."""

import statistics


def read(w):
    return statistics.median(w.step_ms) if w.step_ms else None
