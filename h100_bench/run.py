"""Run one benchmark cell once on the card and print its result.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m h100_bench.run ...        (the same)

Finds the cell in `BENCHMARK.json`, builds the program's objects for it
(`drivers/<driver>.py`), makes the weights and data from `--seed`, warms
up, measures for `--seconds`, then frees the program's state and checks
what the window produced against the plain reference (`reference/`).
With `--trace 1` the window runs under the profiler and the result holds
the cell's per-layer metrics (`metrics/<name>.py`); with `--trace 0` its
end-to-end metrics. The last line of standard output is the result's JSON;
the compared numbers, each beside its limit, are the last lines of standard
error and the result's last key. Without a card, or with fewer than the
cell asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from h100_bench import cell as cells  # noqa: E402
from h100_bench.reference import EXACT  # noqa: E402
from h100_bench.trace import Tracer  # noqa: E402

# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fast_dit_tpu", "benchmarks", "bench",
             "chip_smoke")
ROOT = Path(__file__).resolve().parent.parent


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _fixed_caches() -> None:
    """Every build and kernel cache in a fixed directory of the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool, device, started: float,
            underneath=contextlib.nullcontext) -> dict:
    """One run of `cell` on `device`: set-up, window, check. `started` is
    the host time (perf_counter) the process started at; `underneath(session)`
    is entered around the set-up and the window (the tests plant faults
    there). Returns the result's fields and the checks [(name, value, limit)]."""
    timing = {"to_build_s": time.perf_counter() - started}
    session = cell.driver().Session(cell, device)
    timing["build_s"] = time.perf_counter() - started - timing["to_build_s"]
    tracer = Tracer(trace)
    with underneath(session):
        t = time.perf_counter()
        session.prepare(seed)
        timing["prepare_s"] = time.perf_counter() - t
        t_window = time.perf_counter()
        outcome = session.window(seconds, tracer)
    setup_s = outcome.t0 - started
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window = tracer.window(("train_step", "sample_step", "chain_end")) if trace else None
    timing["window_and_trace_s"] = time.perf_counter() - t_window
    session.release()
    t = time.perf_counter()
    numbers = session.compare(session.reference(EXACT))
    timing["check_s"] = time.perf_counter() - t
    checks = [(name, numbers[name], cell.limits[name]) for name in cell.limits]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    if window is not None:
        window.step_ms = outcome.step_ms[:window.steps]  # the first half's
        window.shape = {"config": cell.config, "traffic": cell.traffic}
        metrics = {}
        for m in cells.per_layer_metrics(cell):
            value = cells.read_metric(m["name"], window, cell.root)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=window.busy_s, window_s=window.window_s)
        extra = {"breakdown": {"device_ops": window.top_ops(10), "idle_gaps": window.gaps}}
    else:
        units = {m["name"]: m["unit"] for m in cells.end_to_end_metrics(cell)}
        values = dict(outcome.metrics, setup_s=setup_s)
        metrics = {k: {"value": values[k], "unit": units[k]} for k in units if k in values}
        extra = {}
    return {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device_info, **extra,
            "info": {"setup_s": setup_s, "timing": timing, "window_s": outcome.window_s,
                     "steps": outcome.steps,
                     "numbers": numbers, "finished_chains": outcome.finished,
                     "trace": None if window is None else {
                         "device_ops": len(window.kernels) + len(window.copies),
                         "steps": window.steps, "unlinked_device_ops": window.unlinked},
                     "worst": getattr(session, "worst", None)}}, checks


def main(argv=None, device=None) -> int:
    started = time.perf_counter() - process_age_s()
    args = parse_args(argv)
    _fixed_caches()
    cell = cells.load(args.workload, ROOT)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
            print(f"h100_bench: {args.workload} needs {cell.entry['chips']} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    result, checks = measure(cell, args.seed, args.seconds, bool(args.trace), device, started)
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: modules loaded that the run may not use: {bad}", file=sys.stderr)
        return 3
    info = result.pop("info")
    print(json.dumps({"info": info}, default=float), file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
