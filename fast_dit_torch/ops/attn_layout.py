"""Clamped packed-qkv attention forward: the hand-written CUDA kernel of the
head-dim layout experiment, and its plain version.

Counterpart of the kernel in `benchmarks/attn_layout_bench.py` (the
benchmark's harness, its `main`, is not carried over). The TPU kernel
`_transposed_kernel` (:59-78, launched by `transposed_forward`, :81-96)
becomes `csrc/attention_transposed_fwd.cu`; `_transposed_forward_plain` is
its contract written out in torch. Both read the packed (B, S, 3D)
projection output (q at column h*hd, k at D + h*hd, v at 2D + h*hd) and
return (B, S, D) in its dtype.

The function is kernel 1's with the clamped softmax of the TPU's bf16 path:
p_u = exp(min(q k^T * scale, 50)) with no row max, rounded once to the input
dtype, and that rounded value feeds both the row sum and the product with v;
the output is divided by max(row sum, 1e-30). Below the clamp this is
softmax attention; above it a row flattens toward a uniform mix of its
clamped keys, which the kernel keeps, where kernel 1
(`flash_attention.py`) is exact. The TPU kernel moves hd to the sublane
axis so that hd 72 pads to 80 rather than to 128 lanes; on the card the
tensor cores already pad 72 only to 80, so the CUDA kernel keeps the tiles
row-major (see the note in its source).

The bf16 body loads its tiles with TMA. `_tma_plan` is the geometry of its
tiles and tensor maps, computed here so that the CPU tests can hold it to
TMA's rules and rebuild every head from it; the C entry point encodes the
maps from it and refuses a plan that is not the one its kernel reads.

`transposed_forward` holds the kernel's contract on every device (that of
`flash_attention.check_qkv`): fp32 or bf16, a contiguous 3-D tensor, hd a
multiple of 8 and at most 128, any S. On a CPU tensor it computes the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import _DTYPE_CODES, _I, _P, _check_cuda, _split_heads, check_qkv

__all__ = ["transposed_forward"]

_CLAMP = 50.0
# qkv, out, B, S, H, hd, scale, dtype, plan, stream
_FWD_ARGS = [_P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P]

# rows of a box of the bf16 body: a stage's keys, a warpgroup's queries
TMA_BOX_ROWS = 64
_PLAN_FIELDS = 16


def _tma_plan(B: int, S: int, H: int, hd: int) -> dict:
    """The tiles of the bf16 body for a packed (B, S, 3*H*hd) bf16 qkv and
    its (B, S, H*hd) output.

    A head's hd columns, padded to `hdp` (a multiple of 16, wgmma's k step),
    are cut into `chunks` (first column, width): 64 columns each, then one of
    32 and/or one of 16, each as wide as a swizzle span (2 x width bytes).
    A query tile has `block_rows` rows (four warpgroups of 64, two at hd >
    96), read as boxes of 64 rows like a stage's 64 keys. The first
    `tma_chunks` (the 64-column ones, or the only one) move by TMA
    through two maps of their width, `qkv` of rank 5 (hd, H, 3, S, B) with
    byte strides (2 hd, 2 D, 6 D, 6 D S) and `out` of rank 4 (hd, H, S, B)
    with (2 hd, 2 D, 2 D S); dims and boxes innermost first, a box (width,
    1, 1, 64, 1) or (width, 1, 64, 1). Coordinates past hd or S read as zeros
    and are not written, which pads a head to the chunk's width and a batch
    row to whole tiles. The other chunks move as 16-byte pieces by threads,
    with the same rule: a piece past hd or S reads as zeros and is not
    written."""
    hdp = -(-hd // 16) * 16
    widths = [64] * (hdp // 64) + [w for w in (32, 16) if hdp % 64 & w]
    chunks, col = [], 0
    for w in widths:
        chunks.append((col, w))
        col += w
    D, w = H * hd, widths[0]
    maps = {"qkv": {"dims": (hd, H, 3, S, B), "strides": (2 * hd, 2 * D, 6 * D, 6 * D * S),
                    "box": (w, 1, 1, TMA_BOX_ROWS, 1), "swizzle": 2 * w},
            "out": {"dims": (hd, H, S, B), "strides": (2 * hd, 2 * D, 2 * D * S),
                    "box": (w, 1, TMA_BOX_ROWS, 1), "swizzle": 2 * w}}
    return {"hdp": hdp, "chunks": chunks, "tma_chunks": max(1, hdp // 64),
            "block_rows": 4 * TMA_BOX_ROWS if hdp <= 96 else 2 * TMA_BOX_ROWS, "maps": maps}


@functools.lru_cache(maxsize=64)
def _plan_array(B: int, S: int, H: int, hd: int):
    """`_tma_plan`'s two maps as the C entry point reads them, 16 int64s
    each: rank, dims[5], strides[4], box[5], swizzle bytes (unused places
    0)."""
    arr = (ctypes.c_longlong * (2 * _PLAN_FIELDS))()
    for i, m in enumerate(_tma_plan(B, S, H, hd)["maps"].values()):
        pad = [0] * (5 - len(m["dims"]))
        arr[i * _PLAN_FIELDS:(i + 1) * _PLAN_FIELDS] = [
            len(m["dims"]), *m["dims"], *pad, *m["strides"], *pad, *m["box"], *pad, m["swizzle"]]
    return arr


def _transposed_forward_plain(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """The TPU kernel's formulas (:68-77) in plain torch, with its roundings:
    s = (q k^T) * scale in fp32, p_u = exp(min(s, 50)), pc = p_u rounded to
    the input dtype, denom = sum pc and o = pc v in fp32, o * (1 / max(denom,
    1e-30)) cast to the input dtype."""
    B, S, threeD = qkv.shape
    q, k, v = _split_heads(qkv, num_heads, 3)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    pc = torch.exp(torch.clamp(s, max=_CLAMP)).to(qkv.dtype).float()
    inv = 1.0 / torch.clamp(pc.sum(dim=-1), min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", pc, v) * inv.transpose(1, 2)[..., None]
    return o.reshape(B, S, threeD // 3).to(qkv.dtype)


def _launch(qkv: torch.Tensor, scale: float, num_heads: int, hd: int) -> torch.Tensor:
    _check_cuda(qkv)
    B, S, threeD = qkv.shape
    fn = _build.function("attention_transposed", "fdt_attention_transposed_fwd", _FWD_ARGS)
    out = torch.empty((B, S, threeD // 3), dtype=qkv.dtype, device=qkv.device)
    _check_cuda(out)
    plan = (ctypes.addressof(_plan_array(B, S, num_heads, hd))
            if qkv.dtype == torch.bfloat16 else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(qkv.data_ptr(), out.data_ptr(), B, S, num_heads, hd, scale,
                  _DTYPE_CODES[qkv.dtype], plan, stream)
    _build.check_status("attention_transposed", code, "attention_transposed launch")
    _build.launch_counts["attention_transposed"] += 1
    return out


def transposed_forward(qkv: torch.Tensor, scale: float, num_heads: int) -> torch.Tensor:
    """Clamped attention over a packed (B, S, 3*H*hd) qkv -> (B, S, H*hd),
    JAX's signature. A CPU tensor takes the plain version; any other device
    launches the kernel or raises."""
    hd = check_qkv(qkv, num_heads)
    if qkv.device.type == "cpu":
        return _transposed_forward_plain(qkv, float(scale), num_heads)
    return _launch(qkv, float(scale), num_heads, hd)
