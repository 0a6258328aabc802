"""A whole run of the tiny cells on the CPU: the result line, discovery by
name, the control and the faults."""

import hashlib
import json

import pytest
import torch

from h100_bench import cell as cells
from h100_bench import faults, run
from h100_bench.reference import EXACT, LOWER
from h100_bench.trace import Tracer
from bench_tiny import SAMPLE, TRAIN, last_json, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", [TRAIN, SAMPLE])
def test_result_line(checkout, workload):
    rc, out, err = run_cell(checkout, "--workload", workload, "--seed", "4294967311",
                            "--seconds", "1", "--trace", "0")
    assert rc == 0, err[-2000:]
    result = last_json(out)
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert "setup_s" in result["metrics"]
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    # the compared numbers, each beside its limit, close standard error
    lines = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in lines] == list(result["checks"])
    assert all(line.startswith("check ") and " limit " in line for line in lines)


def test_traced_result_and_a_metric_added_as_a_new_file(checkout):
    """A configuration, a mix (the tiny ones) and a per-layer metric added
    as new files and entries run without a change to any file there was."""
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (checkout / "h100_bench").rglob("*") if p.is_file()}
    (checkout / "h100_bench/metrics/window_steps.tiny.py").write_text(
        "def read(w):\n    return float(w.steps) if w.steps else None\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "window_steps.tiny", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "sample_images_per_s", "workloads": [SAMPLE]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run_cell(checkout, "--workload", SAMPLE, "--seed", "7", "--seconds", "1",
                            "--trace", "1")
    assert rc == 0, err[-2000:]
    result = last_json(out)
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert 0 < result["metrics"]["window_steps.tiny"]["value"] <= result["attempted"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(hashlib.sha256(p.read_bytes()).hexdigest() == h for p, h in before.items())


def test_no_card_no_result(checkout):
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", TRAIN, "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=checkout,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_only_the_benchmark_and_no_program_no_result(tmp_path, checkout):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    import subprocess
    import sys

    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); from h100_bench import run; "
            "sys.exit(run.main(sys.argv[2:], device=torch.device('cpu')))")
    proc = subprocess.run([sys.executable, "-c", code, str(checkout), "--workload", TRAIN,
                           "--seed", "1", "--seconds", "1"], cwd=checkout,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def _measure(checkout, workload, underneath):
    cell = cells.load(workload, checkout)
    result, checks = run.measure(cell, 11, 0.5, False, torch.device("cpu"), 0.0,
                                 underneath=underneath)
    return result["correct"], {n: (v, lim) for n, v, lim in checks}


@pytest.mark.parametrize("workload,fault", [(TRAIN, f) for f in faults.FAULTS["train"]] +
                         [(SAMPLE, f) for f in faults.FAULTS["sample"]])
def test_each_fault_comes_out_not_correct(checkout, tiny_models, workload, fault):
    correct, checks = _measure(checkout, workload, lambda s: faults.planted(fault, s))
    assert correct is False, checks


@pytest.mark.parametrize("workload", [TRAIN, SAMPLE])
def test_sound_runs_are_correct_and_the_control_is_not(checkout, tiny_models, workload):
    """The control (the reference one precision step lower, in the program's
    place) fails one of the cell's numbers; sound runs of the program pass
    them, on three seeds."""
    cell = cells.load(workload, checkout)
    session = cell.driver().Session(cell, torch.device("cpu"))
    for seed in (1, 2, 3):
        session.prepare(seed)
        session.window(0.5, Tracer(False))
        ref = session.reference(EXACT)
        sound = session.compare(ref)
        assert all(sound[n] <= lim for n, lim in cell.limits.items()), sound
        control = session.compare_control(ref, session.reference(LOWER))
        assert any(control[n] > cell.limits[n] for n in control if n in cell.limits), control
