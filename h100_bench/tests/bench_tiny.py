"""Tiny cells for the benchmark's CPU tests: the configuration at two
blocks of width 64 and patch 8 (16 tokens), registered in the program's
model table under a name of its own, with small traffic and limits set
from their own CPU readings. `write_checkout` copies the benchmark into a
temporary directory with those cells added as new files and entries."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"

TINY_MODELS = {"DiT-T/8": (2, 64, 8, 2)}
TRAIN, SAMPLE = "tiny_dense.tiny_train", "tiny_dense.tiny_sample"
# between the tiny program's readings on the CPU (0.003-0.009, 0 for the
# guidance and the step) and the control's (0.032-0.098, 1.9e-3, 5.3e-3)
LIMITS_SAMPLE = {"embed_gap": 0.02, "adaln_tok_p90": 0.02, "attn_tok_p90": 0.02,
                 "mlp_tok_p90": 0.02, "residual_tok_p90": 0.015, "final_tok_p90": 0.02,
                 "out_row_l2": 0.03, "cfg_gap": 1e-5, "ddpm_step_gap": 1e-5,
                 "timestep_mismatch": 0, "quantized_mismatch": 0}

# run.main on the CPU in a checkout: the tiny models registered first (the
# harness's look for a card is what `device=` skips)
DRIVER = """
import json, sys, torch
sys.path[:0] = [sys.argv[1], {program!r}]
torch.set_num_threads(2)
from fast_dit_torch.models import dit
dit.DiT_models["DiT-T/8"] = dit.dit_config(2, 64, 8, 2)
from h100_bench import run
sys.exit(run.main(sys.argv[2:], device=torch.device("cpu")))
"""


def tiny_files():
    """{relative path: JSON} of the tiny cells' new files."""
    dense = json.loads((BENCH / "configs/dit_xl2_256.json").read_text())
    dense.update(name="tiny_dense", model="DiT-T/8", patch_size=8, hidden_size=64, depth=2,
                 num_heads=2)
    train = json.loads((BENCH / "traffic/train_b128.json").read_text())
    train.update(global_batch=4, pool=4, reference_block_rows=2)
    sample = json.loads((BENCH / "traffic/fid_b32.json").read_text())
    sample.update(labels_per_chain=2, sampling_steps=10, checked_steps=3,
                  checked_blocks=[0, 1], flags=["--bf16", "--sampler", "ddpm"])
    return {
        "h100_bench/configs/tiny_dense.json": dense,
        "h100_bench/traffic/tiny_train.json": train,
        "h100_bench/traffic/tiny_sample.json": sample,
        # between the tiny program's readings on the CPU and the control's
        f"h100_bench/limits/{TRAIN}.json": {"loss_rel_gap": 2e-3, "grad_norm_gap": 0.02,
                                            "update_norm_gap": 0.05},
        f"h100_bench/limits/{SAMPLE}.json": dict(LIMITS_SAMPLE),
    }


def add_tiny_cells(bench: dict) -> dict:
    """BENCHMARK.json with the tiny configurations and cells as new entries."""
    bench = json.loads(json.dumps(bench))
    bench["configs"] += [
        {"name": "tiny_dense", "source": "test", "file": "h100_bench/configs/tiny_dense.json",
         "reduced": [], "why": "test"}]
    bench["workloads"] += [
        {"name": TRAIN, "config": "tiny_dense", "traffic": "tiny_train", "chips": 1,
         "why": "test"},
        {"name": SAMPLE, "config": "tiny_dense", "traffic": "tiny_sample", "chips": 1,
         "why": "test"}]
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            cells = m.get("workloads")
            if cells is not None:
                m["workloads"] = cells + [TRAIN if any(".train" in c for c in cells) else SAMPLE]
    return bench


def write_checkout(dest: Path) -> Path:
    shutil.copytree(BENCH, dest / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, data in tiny_files().items():
        (dest / rel).write_text(json.dumps(data))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "BENCHMARK.json").write_text(json.dumps(add_tiny_cells(bench)))
    return dest


def run_cell(checkout: Path, *args, timeout=300):
    """(returncode, stdout, stderr) of run.main in `checkout` on the CPU."""
    code = DRIVER.format(program=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code, str(checkout), *args],
                          capture_output=True, text=True, timeout=timeout, cwd=checkout)
    return proc.returncode, proc.stdout, proc.stderr


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
