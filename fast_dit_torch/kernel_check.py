"""Hold the attention kernels against a float64 oracle at 256 to 4096 tokens.

    python -m fast_dit_torch.kernel_check                              # on the card
    python -m fast_dit_torch.kernel_check --device cpu --max-seq 512 --heads 2

Counterpart of `tools/tpu_kernel_check.py`. Each case draws its inputs from
a seeded `torch.Generator`, runs the port's entry point and compares its
forward output and its input gradients with softmax attention and its
closed-form gradient computed in `torch.float64` on the tensors' own device
(`oracle_fp64`, the formulas of JAX's `oracle_fp64`, :49-73):

- kernels 1 and 2 through `flash_attention_qkv_flat` with autograd (the
  forward kernel writing the rows' LSE, then the backward kernel) at S =
  256, 512, 1024, 2048 and 4096, B = 2 up to 1024 tokens and 1 above, H =
  16, hd = 72, inputs x 0.5, fp32 and bf16; at S = 256 also the inference
  call, the forward kernel without a gradient;
- kernels 4 and 5 through one ring hop (`ops.ring_attention._RingHopFn`) on
  one shard, q, k and v on the same S, the output normalised by l: JAX's
  `RING_CASES` (1024 fp32; 1024, 2048 and 4096 bf16) and fp32 at 2048 and
  4096, since the port keeps no VMEM bound. With logits below the clamp the
  normalised hop is exact softmax attention, so the same oracle applies.

Limits against fp64, absolute: fp32 2e-5 in every case (the bound of JAX's
fp32 Pallas path; the port has a kernel at every S), bf16 5e-2 (storage
rounding alone is 4e-3). Every case prints one JSON row, as JAX's does, plus
the kernels' times (`kernel_ms` forward, `bwd_kernel_ms` backward: CUDA
events over the calls on the card, the host clock on the CPU), then a
summary row; the exit code is 1 if any case fails. On the CPU the plain
versions run in the kernels' place.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .ops.flash_attention import (_attention_qkv_bwd_plain, _attention_qkv_plain, _launch_bwd,
                                  _launch_fwd, flash_attention_qkv_flat)
from .ops.ring_attention import (_hop_backward_plain, _hop_forward_plain, _launch_hop_bwd,
                                 _launch_hop_fwd, _RingHopFn)
from .utils.device import resolve_device, tf32

__all__ = ["CASES", "RING_CASES", "TOL", "oracle_fp64", "check", "check_ring_hop", "main"]

CASES = [256, 512, 1024, 2048, 4096]
RING_CASES = [(1024, "float32"), (1024, "bfloat16"), (2048, "bfloat16"), (4096, "bfloat16"),
              (2048, "float32"), (4096, "float32")]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
HEADS, HEAD_DIM = 16, 72
TIME_ITERS = 5
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def oracle_fp64(qkv: torch.Tensor, g: torch.Tensor):
    """Attention forward and input gradients in float64 on qkv's device.
    qkv (B, S, 3, H, hd), g (B, S, H, hd) -> (out (B, S, H, hd), dqkv
    (B, S, 3, H, hd)), both float64. One head at a time, so the (B, S, S)
    probabilities of only one head are held."""
    qkv, g = qkv.double(), g.double()
    B, S, _, H, hd = qkv.shape
    scale = hd ** -0.5
    out = torch.empty((B, S, H, hd), dtype=torch.float64, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    for h in range(H):
        q, k, v = (qkv[:, :, i, h] for i in range(3))
        go = g[:, :, h]
        s = (q @ k.transpose(1, 2)) * scale
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        out[:, :, h] = p @ v
        dv = p.transpose(1, 2) @ go
        dp = go @ v.transpose(1, 2)
        delta = (p * dp).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        dqkv[:, :, 0, h] = ds @ k
        dqkv[:, :, 1, h] = ds.transpose(1, 2) @ q
        dqkv[:, :, 2, h] = dv
        del s, p, dp, ds
    return out, dqkv


def _ms(fn, device, iters=TIME_ITERS) -> float:
    """Mean milliseconds of `fn` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _row(S, dtype_name, impl, f_err, g_err, B, H, hd, kernel_ms, bwd_ms):
    tol = TOL[dtype_name]
    return {"S": S, "dtype": dtype_name, "fwd_impl": impl, "B": B, "H": H, "hd": hd,
            "fwd_max_abs_err": f_err, "fwd_tol": tol,
            "grad_max_abs_err": g_err, "grad_tol": None if g_err is None else tol,
            "fwd_ok": f_err <= tol, "grad_ok": g_err is None or g_err <= tol,
            "kernel_ms": kernel_ms, "bwd_kernel_ms": bwd_ms}


def check(S, dtype_name, device, grad=True, B=None, H=HEADS, hd=HEAD_DIM, timed=True):
    """Kernels 1 and 2 (or, on the CPU, their plain versions) at S tokens
    against `oracle_fp64`; `grad=False` checks the inference call alone."""
    dtype = _DTYPES[dtype_name]
    B = B or (2 if S <= 1024 else 1)
    D = H * hd
    gen = torch.Generator(device=device).manual_seed(S)
    qkv5 = (torch.randn((B, S, 3, H, hd), generator=gen, device=device) * 0.5).to(dtype)
    g = torch.randn((B, S, H, hd), generator=gen, device=device).to(dtype)
    qkv = qkv5.reshape(B, S, 3 * D).detach().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        out = flash_attention_qkv_flat(qkv, H)
    if grad:
        out.backward(g.reshape(B, S, D))
    ref_out, ref_dqkv = oracle_fp64(qkv5, g)
    f_err = (out.detach().double().reshape(B, S, H, hd) - ref_out).abs().max().item()
    g_err = None
    if grad:
        g_err = (qkv.grad.double().reshape(B, S, 3, H, hd) - ref_dqkv).abs().max().item()
    del ref_out, ref_dqkv
    kernel_ms = bwd_ms = None
    if timed:
        x = qkv.detach()
        scale = hd ** -0.5
        if device.type == "cuda":
            kernel_ms = _ms(lambda: _launch_fwd(x, H, hd, scale, with_lse=grad), device)
            if grad:
                o, lse = _launch_fwd(x, H, hd, scale, with_lse=True)
                do = g.reshape(B, S, D).contiguous()
                bwd_ms = _ms(lambda: _launch_bwd(x, o, do, lse, H, hd, scale), device)
        else:
            kernel_ms = _ms(lambda: _attention_qkv_plain(x, H, scale), device, iters=1)
            if grad:
                do = g.reshape(B, S, D)
                bwd_ms = _ms(lambda: _attention_qkv_bwd_plain(x, do, H, scale), device, iters=1)
    impl = ("kernel" if device.type == "cuda" else "plain") + ("" if grad else "-inference")
    return _row(S, dtype_name, impl, f_err, g_err, B, H, hd, kernel_ms, bwd_ms)


def check_ring_hop(S, dtype_name, device, B=1, H=HEADS, hd=HEAD_DIM, timed=True):
    """Kernels 4 and 5 (or their plain versions) on one shard, q, k and v of
    S tokens, the output o / l against `oracle_fp64`."""
    dtype = _DTYPES[dtype_name]
    D = H * hd
    scale = hd ** -0.5
    gen = torch.Generator(device=device).manual_seed(S + 7)
    qf, kf, vf = ((torch.randn((B, S, D), generator=gen, device=device) * 0.5).to(dtype)
                  .requires_grad_(True) for _ in range(3))
    g = torch.randn((B, S, H, hd), generator=gen, device=device)
    o, l = _RingHopFn.apply(qf, kf, vf, scale, H)
    out = o.reshape(B, S, H, hd) / torch.clamp(l, min=1e-30)[..., None]
    (out * g).sum().backward()
    qkv5 = torch.stack([t.detach().reshape(B, S, H, hd) for t in (qf, kf, vf)], dim=2)
    ref_out, ref_dqkv = oracle_fp64(qkv5, g)
    f_err = (out.detach().double() - ref_out).abs().max().item()
    g_err = max((t.grad.double().reshape(B, S, H, hd) - ref_dqkv[:, :, i]).abs().max().item()
                for i, t in enumerate((qf, kf, vf)))
    del ref_out, ref_dqkv
    kernel_ms = bwd_ms = None
    if timed:
        q, k, v = (t.detach() for t in (qf, kf, vf))
        go = torch.randn((B, S, D), generator=gen, device=device)
        gl = torch.randn((B, S, H), generator=gen, device=device)
        if device.type == "cuda":
            kernel_ms = _ms(lambda: _launch_hop_fwd(q, k, v, scale, H), device)
            bwd_ms = _ms(lambda: _launch_hop_bwd(q, k, v, go, gl, scale, H), device)
        else:
            kernel_ms = _ms(lambda: _hop_forward_plain(q, k, v, scale, H), device, iters=1)
            bwd_ms = _ms(lambda: _hop_backward_plain(q, k, v, go, gl, scale, H), device,
                         iters=1)
    impl = "ring-hop" if device.type == "cuda" else "ring-hop-plain"
    return _row(S, dtype_name, impl, f_err, g_err, B, H, hd, kernel_ms, bwd_ms)


def run(device, max_seq=4096, heads=HEADS, emit=print):
    """Every case up to `max_seq` tokens; `emit` gets each JSON row. Returns
    (rows, failures)."""
    rows = []

    def add(row, regime):
        row["regime"] = regime
        rows.append(row)
        emit(json.dumps(row))

    # the oracle and the kernels compare exact fp32 products: no TF32
    with tf32(False):
        for S in (s for s in CASES if s <= max_seq):
            for dtype_name in ("float32", "bfloat16"):
                if S == 256:
                    add(check(S, dtype_name, device, grad=False, H=heads), "inference")
                add(check(S, dtype_name, device, H=heads), "fwd+bwd")
        for S, dtype_name in ((s, d) for s, d in RING_CASES if s <= max_seq):
            add(check_ring_hop(S, dtype_name, device, H=heads), "ring-hop")
    failures = sum(not (r["fwd_ok"] and r["grad_ok"]) for r in rows)
    return rows, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-seq", type=int, default=max(CASES),
                    help="skip the cases above this many tokens (a short run on the CPU)")
    ap.add_argument("--heads", type=int, default=HEADS,
                    help="attention heads of every case (16 in JAX's check)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"fast_dit_torch.kernel_check: {e}") from None
    rows, failures = run(device, args.max_seq, args.heads,
                         emit=lambda s: print(s, flush=True))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"cases": len(rows), "failures": failures, "device": name}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
