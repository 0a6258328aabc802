"""Kernels 1 and 2 (the attention forward, with the row LSE, and backward)
in the train step, as a share of their bound: the sum over calls of
max(bytes / HBM bandwidth, FLOPs / bf16 peak), from the cell's shapes,
over the kernels' device time. A call of kernel 2 launches two kernels, its
dq pass and its dk/dv pass."""

from h100_bench import counts

FWD, BWD, BWD_CALL = r"attention_fwd", r"attention_bwd", r"attention_bwd_dq|attention_bwd_kernel"


def read(w):
    cfg, tr = w.shape["config"], w.shape["traffic"]
    n_fwd, n_bwd = w.kernel_count(FWD), w.kernel_count(BWD_CALL)
    seconds = w.kernel_s(FWD) + w.kernel_s(BWD)
    if not n_fwd or not seconds:
        return None
    B, S, H = tr["global_batch"], counts.tokens(cfg), cfg["num_heads"]
    hd = cfg["hidden_size"] // H
    bound = (n_fwd * counts.bound_s(*counts.attention_fwd(B, S, H, hd, with_lse=True))
             + n_bwd * counts.bound_s(*counts.attention_bwd(B, S, H, hd)))
    return 100.0 * bound / seconds
