"""Kernel 1 (the attention forward) in the guided sampling step, as a share
of its bound: calls x max(bytes / HBM bandwidth, FLOPs / bf16 peak) at the
doubled batch, over the kernel's device time."""

from h100_bench import counts

FWD = r"attention_fwd"


def read(w):
    cfg, tr = w.shape["config"], w.shape["traffic"]
    n, seconds = w.kernel_count(FWD), w.kernel_s(FWD)
    if not n or not seconds:
        return None
    S, H = counts.tokens(cfg), cfg["num_heads"]
    B = 2 * tr["labels_per_chain"]
    return 100.0 * n * counts.bound_s(*counts.attention_fwd(B, S, H, cfg["hidden_size"] // H)) \
        / seconds
