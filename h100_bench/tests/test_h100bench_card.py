"""On the card only: one short run of each real cell from the committed
files, correct and with every end-to-end metric.

    python -m pytest h100_bench/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dit_xl2_256.train_b128", "dit_xl2_256.fid_b32"])
def test_cell_runs_correct_on_the_card(card, workload):
    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", workload,
                           "--seed", "2718281828", "--seconds", "3", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and "setup_s" in result["metrics"]
