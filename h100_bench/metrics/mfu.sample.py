"""Model FLOPs of the window's guided steps over what the card's bf16 peak
gives in the window: one forward of the doubled batch a step."""

from h100_bench import counts


def read(w):
    if not w.steps or not w.window_s:
        return None
    rows = 2 * w.shape["traffic"]["labels_per_chain"]
    return 100.0 * counts.forward_flops(w.shape["config"]) * rows * w.steps \
        / (w.window_s * counts.PEAK_BF16_FLOPS)
