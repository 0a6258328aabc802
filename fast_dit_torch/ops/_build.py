"""Build the port's CUDA kernels with `nvcc` and load them with ctypes.

Each source under `fast_dit_torch/csrc/` compiles into its own shared
library with a plain C interface (`sm_90a`, `-O3`), at first use, into
`build/` at the repository root. The file name carries a hash of the source,
every header under `csrc/` (`*.cuh`) and the flags, so an edited source or
header builds anew and an unchanged one is loaded as it is. All sources
compile in parallel, one `nvcc` each.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "function", "launch_counts",
           "reset_launch_counts", "check_status"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> source file under csrc/
SOURCES = {"flash_attention_fwd": "flash_attention_fwd.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "fused_update": "fused_update.cu",
           "ring_hop_fwd": "ring_hop_fwd.cu",
           "ring_hop_bwd": "ring_hop_bwd.cu",
           "attention_transposed": "attention_transposed_fwd.cu"}

# kernel name -> launches since the last reset; each wrapper adds one where
# it launches its kernel, and nowhere else (the two backwards count one per
# call, though each launches two passes; the fused update counts its fp32-nu
# and its bf16-nu instantiation apart)
launch_counts = {"attention_fwd": 0, "attention_bwd": 0, "fused_adamw_ema": 0,
                 "fused_adamw_ema_nu_bf16": 0, "ring_hop_fwd": 0, "ring_hop_bwd": 0,
                 "attention_transposed": 0}

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build on the machine with the card")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> dict:
    """Compile every named source whose library is missing, one `nvcc` per
    source, all started together. Returns {name: library path}. Raises with
    the compiler's output if any build fails; the ptxas report of a build
    stays beside its library as `<lib>.log`."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[n]} (rc {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        if name not in _libs:
            path = build_all([name])[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def function(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of library `name`, typed once: int return,
    `argtypes` (ctypes.c_void_p for every pointer and the stream)."""
    key = (name, symbol)
    if key not in _fns:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[key] = fn
    return _fns[key]


def check_status(name: str, code: int, what: str) -> None:
    """Raise if a C entry point of library `name` returned a nonzero
    cudaError_t."""
    if code != 0:
        lib = load(name)
        lib.fdt_error_string.restype = ctypes.c_char_p
        lib.fdt_error_string.argtypes = [ctypes.c_int]
        msg = lib.fdt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
