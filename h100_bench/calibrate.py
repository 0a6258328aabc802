"""The readings that a cell's limits are set from, at the cell's own size,
in one process (the benchmark's own runs do not run this):

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds s] [--fault-seconds s]

For every seed of `--seeds`, a sound run of the program: its set-up, a
window of `--seconds` and the numbers that decide `correct` (the lower
reading of each is the largest over the seeds). For every seed of
`--control-seeds`, the control: the reference put in the program's place
one precision step lower (`reference.LOWER`), compared with the reference
by the same numbers (the upper reading). For every seed of
`--fault-seeds`, each fault the cell can have, planted in the program
(`faults.py`), with windows of `--fault-seconds`. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from h100_bench import cell as cells  # noqa: E402
from h100_bench import faults  # noqa: E402
from h100_bench.reference import EXACT, LOWER  # noqa: E402
from h100_bench.trace import Tracer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell, device, seeds, control_seeds, fault_seeds, seconds, emit,
             fault_seconds=None) -> None:
    session = cell.driver().Session(cell, device)
    # sampling runs the whole guided forward here whatever the limits read,
    # so that its gaps are on record
    whole = {"full": True} if cell.traffic["driver"] == "sample" else {}

    def _reference(session, prec):
        return session.reference(prec, **whole)

    for seed in seeds:
        t = time.perf_counter()
        session.prepare(seed)
        out = session.window(seconds, Tracer(False))
        ref = _reference(session, EXACT)
        emit({"kind": "program", "seed": seed, "numbers": session.compare(ref),
              "steps": out.steps, "metrics": out.metrics, "s": time.perf_counter() - t})
        if seed in control_seeds:
            emit({"kind": "control", "seed": seed,
                  "numbers": session.compare_control(ref, _reference(session, LOWER))})
    for name in faults.FAULTS[cell.traffic["driver"]]:
        for seed in fault_seeds:
            with faults.planted(name, session):
                session.prepare(seed)
                session.window(fault_seconds or seconds, Tracer(False))
            emit({"kind": f"fault:{name}", "seed": seed,
                  "numbers": session.compare(session.reference(EXACT))})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fault-seconds", type=float, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload, ROOT)
    readings(cell, torch.device("cuda", 0), args.seeds, set(args.control_seeds),
             args.fault_seeds, args.seconds,
             lambda row: print(json.dumps(row, default=float), flush=True), args.fault_seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
