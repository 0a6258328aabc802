"""Kernel 3 (the fused AdamW + EMA update, fp32 nu) as a share of its bound:
32 bytes an element over HBM bandwidth, every trainable element once a
step, over the kernel's device time a step."""

from h100_bench import counts

KERNEL = r"fused_adamw_ema"


def read(w):
    seconds = w.kernel_s(KERNEL)
    if not w.steps or not seconds:
        return None
    n = counts.trainable_params(w.shape["config"])
    return 100.0 * counts.adamw_ema_bytes(n) / counts.HBM_BYTES_PER_S / (seconds / w.steps)
