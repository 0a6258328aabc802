"""The port's kernel check (fast_dit_torch/kernel_check.py) against JAX's
(`tools/tpu_kernel_check.py`): its float64 oracle equals JAX's
`oracle_fp64` within 1e-12 on the same inputs, and on the CPU the plain
attention and ring-hop versions, which stand in for kernels 1, 2, 4 and 5
here, are held to that oracle at S = 2048 with 2 heads of 72, within the
check's own limits (fp32 2e-5, bf16 5e-2 absolute). The kernels themselves
run only on the card (`chip_smoke.py` phase `kernel_check`, S = 256 to 4096,
16 heads).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from fast_dit_torch import kernel_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_check():
    spec = importlib.util.spec_from_file_location(
        "tpu_kernel_check", os.path.join(REPO, "tools", "tpu_kernel_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,S,H,hd", [(2, 64, 3, 16), (1, 200, 2, 72)])
def test_oracle_equals_jax_oracle(B, S, H, hd):
    rs = np.random.RandomState(S)
    qkv = (rs.randn(B, S, 3, H, hd) * 0.5).astype(np.float32)
    g = rs.randn(B, S, H, hd).astype(np.float32)
    want_out, want_dqkv = _jax_check().oracle_fp64(qkv, g)
    out, dqkv = kernel_check.oracle_fp64(torch.from_numpy(qkv), torch.from_numpy(g))
    assert out.dtype == dqkv.dtype == torch.float64
    assert np.abs(out.numpy() - want_out).max() <= 1e-12
    assert np.abs(dqkv.numpy() - want_dqkv).max() <= 1e-12


def test_cases_and_limits_are_jax_cases_and_limits():
    jax_check = _jax_check()
    assert kernel_check.CASES == [S for S, _ in jax_check.CASES]
    # JAX's ring cases, and fp32 where JAX's VMEM bound stopped it
    assert kernel_check.RING_CASES[:4] == jax_check.RING_CASES
    assert kernel_check.RING_CASES[4:] == [(2048, "float32"), (4096, "float32")]
    assert kernel_check.TOL == {"float32": 2e-5, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad", [True, False], ids=["fwd+bwd", "inference"])
def test_plain_attention_within_the_limits_at_2048_tokens(dtype, grad):
    row = kernel_check.check(2048, dtype, CPU, grad=grad, H=2, timed=False)
    assert (row["B"], row["H"], row["hd"]) == (1, 2, 72)
    assert row["fwd_ok"] and row["grad_ok"], row
    assert (row["grad_max_abs_err"] is None) == (not grad)
    if dtype == "float32":  # the plain version is fp32 throughout
        assert row["fwd_max_abs_err"] < 1e-6
        assert grad is False or row["grad_max_abs_err"] < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ring_hop_within_the_limits_at_2048_tokens(dtype):
    row = kernel_check.check_ring_hop(2048, dtype, CPU, H=2, timed=False)
    assert row["fwd_impl"] == "ring-hop-plain"
    assert row["fwd_ok"] and row["grad_ok"], row
    if dtype == "float32":
        assert max(row["fwd_max_abs_err"], row["grad_max_abs_err"]) < 1e-6


def test_cli_on_the_cpu_prints_a_row_a_case(capsys):
    assert kernel_check.main(["--device", "cpu", "--max-seq", "512", "--heads", "2"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    cases, summary = rows[:-1], rows[-1]
    # S = 256 with and without a gradient, 512 with one, in both dtypes
    assert [(r["S"], r["dtype"], r["regime"]) for r in cases] == [
        (256, "float32", "inference"), (256, "float32", "fwd+bwd"),
        (256, "bfloat16", "inference"), (256, "bfloat16", "fwd+bwd"),
        (512, "float32", "fwd+bwd"), (512, "bfloat16", "fwd+bwd")]
    assert all(r["kernel_ms"] > 0 for r in cases)
    assert summary == {"cases": 6, "failures": 0, "device": "cpu"}


def test_cli_exits_1_when_a_case_fails(monkeypatch, capsys):
    monkeypatch.setattr(kernel_check, "TOL", {"float32": 0.0, "bfloat16": 0.0})
    assert kernel_check.main(["--device", "cpu", "--max-seq", "256", "--heads", "1"]) == 1
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["failures"] == 4


def test_cli_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        kernel_check.main(["--max-seq", "256"])
