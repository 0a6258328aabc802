"""Model FLOPs of the window's train steps over what the card's bf16 peak
gives in the window: 3 forwards a row (the recomputed forward of
activation checkpointing not counted), batch rows a step."""

from h100_bench import counts


def read(w):
    if not w.steps or not w.window_s:
        return None
    flops = counts.train_flops_per_image(w.shape["config"]) * w.shape["traffic"]["global_batch"]
    return 100.0 * flops * w.steps / (w.window_s * counts.PEAK_BF16_FLOPS)
