"""The port's validation kit (fast_dit_torch/validate_pretrained.py) against
JAX's (`tools/validate_pretrained.py`), on the CPU.

- Its functional-torch oracle equals JAX's `torch_oracle_forward` bit for
  bit on the same state dict, and its `random_state_dict` equals JAX's.
- `--dry-run --device cpu` passes every step and writes JAX's summary.
- A corrupted weight (a NaN in one projection) fails step A with a FAIL line
  and exit 1.
- The day-one drill, the port's form of JAX's slow-marked
  `tests/test_cli.py::test_day_one_drill_full_validation`: the trainer CLI
  with `--export-pt` (DiT-S/8, synthetic data, 2 steps), a full validation
  run of the exported `.pt` with a random f8-small diffusers `.bin`
  (`chip_smoke.write_random_vae`), then `evaluate_samples` on its npz.
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from fast_dit_torch import evaluate_samples, validate_pretrained
from fast_dit_torch.models import DiT_models
from fast_dit_torch.train import cli as train_cli
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_kit():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_pretrained", os.path.join(REPO, "tools", "validate_pretrained.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("depth,hidden,patch,heads,input_size",
                         [(2, 32, 2, 4, 8), (3, 48, 4, 6, 16)])
def test_oracle_and_random_state_dict_equal_jax(depth, hidden, patch, heads, input_size):
    jax_kit = _jax_kit()
    sd = validate_pretrained.random_state_dict(depth, hidden, patch, 4, 10, input_size, seed=3)
    want_sd = jax_kit.random_state_dict(depth, hidden, patch, 4, 10, input_size, seed=3)
    assert sd.keys() == want_sd.keys()
    assert all(np.array_equal(sd[k], want_sd[k]) for k in sd)
    rs = np.random.RandomState(1)
    x = rs.randn(3, 4, input_size, input_size).astype(np.float32)
    t = np.array([0, 37, 999], np.int64)
    y = np.array([1, 10, 4], np.int64)
    want = jax_kit.torch_oracle_forward(want_sd, x, t, y, heads)
    got = validate_pretrained.torch_oracle_forward(
        {k: torch.from_numpy(v) for k, v in sd.items()}, torch.from_numpy(x),
        torch.from_numpy(t), torch.from_numpy(y), heads)
    assert got.shape == (3, 8, input_size, input_size)
    assert np.array_equal(got.numpy(), want)


def test_dry_run_passes_every_step(tmp_path, capsys):
    out = tmp_path / "validate"
    assert validate_pretrained.main(["--dry-run", "--device", "cpu",
                                     "--out-dir", str(out)]) == 0
    text = capsys.readouterr().out
    for step in ("[OK] A activation parity", "[OK] B VAE import", "[OK] C demo-label",
                 "[OK] D1 sample_ddp npz contract", "[OK] D2 FID pipeline"):
        assert step in text, text
    assert "FAIL" not in text and text.splitlines()[-1].startswith("ALL CHECKS PASSED")
    summary = json.loads((out / "validate_summary.json").read_text())
    assert summary["ok"] and summary["parity_max_abs"] < 1e-5
    assert summary["image_size"] == 64 and np.isfinite(summary["fid"])
    assert (out / "validate_grid.png").stat().st_size > 0


def test_a_corrupted_weight_fails_step_a(tmp_path, capsys):
    sd = validate_pretrained.random_state_dict(2, 32, 2, 4, 1000, 32)
    sd["blocks.1.attn.qkv.weight"][5, 7] = np.nan
    pt = str(tmp_path / "corrupt.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    # DiT-S/2's depth and width cut to the corrupt file's: a registered config
    DiT_models["DiT-tiny"] = functools.partial(DiT_models["DiT-S/2"], depth=2, hidden_size=32,
                                               num_heads=4)
    try:
        rc = validate_pretrained.main(["--dit", pt, "--model", "DiT-tiny", "--skip-fid",
                                       "--num-sampling-steps", "2", "--device", "cpu",
                                       "--out-dir", str(tmp_path / "out")])
    finally:
        del DiT_models["DiT-tiny"]
    text = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] A activation parity" in text
    assert text.splitlines()[-1].startswith("VALIDATION FAILED")
    assert not json.loads((tmp_path / "out" / "validate_summary.json").read_text())["ok"]


def test_day_one_drill(tmp_path, capsys):
    results = tmp_path / "results"
    train_cli.main(train_cli.parse_args([
        "--device", "cpu", "--model", "DiT-S/8", "--synthetic-data", "--global-batch-size", "8",
        "--max-steps", "2", "--log-every", "1", "--results-dir", str(results), "--epochs", "1",
        "--export-pt"]))
    (exp,) = os.listdir(results)
    ckpt_dir = results / exp / "checkpoints"
    (pt,) = [f for f in os.listdir(ckpt_dir) if f.endswith("-ema.pt")]
    vae_bin = chip_smoke.write_random_vae(str(tmp_path / "vae.bin"), (32, 32, 64, 64), seed=3)

    out_dir = tmp_path / "validate"
    capsys.readouterr()
    rc = validate_pretrained.main([
        "--dit", str(ckpt_dir / pt), "--model", "DiT-S/8", "--image-size", "256",
        "--num-sampling-steps", "4", "--cfg-scale", "1.5", "--num-fid-samples", "16",
        "--vae", vae_bin, "--vae-config", "f8-small", "--out-dir", str(out_dir),
        "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "ALL CHECKS PASSED" in text
    summary = json.loads((out_dir / "validate_summary.json").read_text())
    assert summary["ok"] and summary["parity_max_abs"] < 1e-3 and summary["vae"] == vae_bin

    npzs = [os.path.join(r, f) for r, _, fs in os.walk(out_dir / "fid_samples")
            for f in fs if f.endswith(".npz")]
    assert len(npzs) == 1
    assert np.load(npzs[0])["arr_0"].shape == (16, 256, 256, 3)
    ref_npz = str(tmp_path / "ref.npz")
    np.savez(ref_npz, arr_0=np.random.RandomState(0).randint(0, 256, (16, 256, 256, 3),
                                                             np.uint8))
    res = evaluate_samples.main(["--generated", npzs[0], "--reference", ref_npz,
                                 "--feature-net", "random"])
    assert np.isfinite(res["fid"]) and res["fid"] > 0


def test_cli_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        validate_pretrained.main(["--dry-run", "--out-dir", str(tmp_path)])


def test_a_full_run_needs_weights(tmp_path):
    with pytest.raises(SystemExit, match="--dit is required"):
        validate_pretrained.main(["--device", "cpu", "--out-dir", str(tmp_path)])
