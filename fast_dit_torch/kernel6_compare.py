r"""Time kernel 6's bf16 body beside other builds of its source, on one card.

    python3 -m fast_dit_torch.kernel6_compare \
        --other pr16=PARENT/fast_dit_torch/csrc/attention_transposed_fwd.cu

Each `--other NAME=PATH` source is compiled as `ops/_build.py` compiles this
checkout's (one nvcc each, in parallel), checked against the plain version
at small ragged shapes and at the bench shapes, then timed beside this
checkout's kernel, kernel 1 and SDPA on the same inputs, in turns (this,
the others, the others again, this), as `chip_smoke.py`'s `cuda_ms` times.
A source whose entry point takes no plan (the kernel's earlier form) is
called without one.
Prints one JSON line per shape, and the card's name and power limit first.
Needs a CUDA card and nvcc, as `chip_smoke.py` does; the other sources come
from elsewhere (e.g. `git archive` of the parent commit in an ignored
directory).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import torch

from .ops import _build
from .ops.attn_layout import (_FWD_ARGS, _plan_array, _transposed_forward_plain,
                              transposed_forward)
from .ops.flash_attention import _I, _P, flash_attention_qkv_flat

CHECKS = [(1, 7, 2, 128), (3, 65, 4, 8), (2, 130, 3, 40), (1, 129, 3, 120), (2, 1000, 2, 72)]
SHAPES = [(16, 256, 16, 72), (16, 256, 16, 128), (16, 180, 16, 72), (32, 256, 16, 72)]
TOL = 2e-2  # bf16, as chip_smoke.py


def _load(name: str, source: str, proc: subprocess.Popen, out: str):
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    fn = ctypes.CDLL(out).fdt_attention_transposed_fwd
    fn.restype = ctypes.c_int
    with_plan = "const long long* plan" in open(source).read()
    fn.argtypes = _FWD_ARGS if with_plan else [_P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P]

    def call(qkv, H, hd, scale):
        B, S, _ = qkv.shape
        out_t = torch.empty(B, S, H * hd, dtype=qkv.dtype, device=qkv.device)
        args = [qkv.data_ptr(), out_t.data_ptr(), B, S, H, hd, scale, 1]
        if with_plan:
            args.append(ctypes.addressof(_plan_array(B, S, H, hd)))
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")
        return out_t
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another attention_transposed_fwd.cu to build and time")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel6_compare needs a CUDA card")
    import chip_smoke  # the card's timer and bound, from the repository root

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    others = dict(o.split("=", 1) for o in a.other)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: (p, str(_build.BUILD_DIR / f"kernel6_{n}.so")) for n, p in others.items()}
    procs = {n: (p, o, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", o, p],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)) for n, (p, o) in procs.items()}
    _build.build_all(["attention_transposed"])
    fns = {"this": lambda qkv, H, hd, scale: transposed_forward(qkv, scale, H)}
    fns.update({n: _load(n, p, proc, o) for n, (p, o, proc) in procs.items()})

    g = torch.Generator(device="cuda").manual_seed(17)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, S, H, hd in CHECKS + SHAPES:
        qkv = torch.randn(B, S, 3 * H * hd, generator=g, device="cuda").to(torch.bfloat16)
        D, scale = H * hd, hd ** -0.5
        ref = _transposed_forward_plain(qkv, scale, H).float()
        err = {n: (f(qkv, H, hd, scale).float() - ref).abs().max().item() for n, f in fns.items()}
        if not all(e <= TOL for e in err.values()):
            raise AssertionError(f"{(B, S, H, hd)}: max abs err {err} > {TOL}")
        row = {"shape": [B, S, H, hd], "max_abs_err": err}
        if (B, S, H, hd) in SHAPES:
            order = list(fns) + list(fns)[::-1]
            ms = {n: [] for n in fns}
            for n in order:
                ms[n].append(chip_smoke.cuda_ms(lambda: fns[n](qkv, H, hd, scale)))
            q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, S, H, hd).transpose(1, 2)
                       for i in range(3))
            row.update(ms=ms, attention_fwd_ms=chip_smoke.cuda_ms(
                lambda: flash_attention_qkv_flat(qkv, H)),
                library_ms=chip_smoke.cuda_ms(lambda: sdpa(q, k, v, scale=scale)),
                bound_ms=chip_smoke.attention_bound_ms(B, S, H, hd, torch.bfloat16)[0])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
