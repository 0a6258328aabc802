"""The port's FID sampling harness (`python -m fast_dit_torch.sample_ddp`)
against the JAX harness's contract (the root `sample_ddp.py`).

A small DiT-S/2 at 256² (`--ckpt random`) and a random diffusers-format
VAE at 2 narrow stages (64² images) keep the runs on the CPU to seconds.
Images are checked against the port's own `generate` with the documented
per-process generator; quantisation against JAX's on the same floats.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_vae import make_vae_state_dict

from fast_dit_torch import sample_ddp as cli
from fast_dit_torch.sample import build_model, build_vae
from fast_dit_torch.diffusion import create_diffusion
from fast_dit_torch.utils.image import decode_png
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE = (32, 64)
FOLDER = "DiT-S-2-random-size-256-vae-ema-cfg-1.5-seed-{seed}"


def _vae_bin(tmp_path):
    path = str(tmp_path / "vae.bin")
    torch.save({k: torch.from_numpy(v) for k, v in make_vae_state_dict(0, VAE, 4).items()}, path)
    return path


def _flags(tmp_path, vae_bin, *extra):
    return ["--device", "cpu", "--model", "DiT-S/2", "--ckpt", "random", "--vae-ckpt", vae_bin,
            "--vae-channels", ",".join(map(str, VAE)), "--num-sampling-steps", "2",
            "--sample-dir", str(tmp_path / "samples"), "--io-threads", "2", *extra]


def _read_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def _near(got, want):
    """uint8 images from processes with other CPU thread counts: the
    convolutions sum in other orders, so a value within ~1e-6 of an integer
    may truncate one level apart; at most 1 % of the values may."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return got.shape == want.shape and diff.max() <= 1 and (diff > 0).mean() <= 0.01


def _expected(args, seed, batches):
    """The uint8 images one process of seed `seed` makes, batch after batch."""
    device = torch.device("cpu")
    model = build_model(args, device, seed=0)
    diffusion = create_diffusion(str(args.num_sampling_steps), device=device)
    vae = build_vae(args, device)
    g = torch.Generator().manual_seed(seed)
    return [cli.generate(args, model, diffusion, vae, g).numpy() for _ in range(batches)]


def test_sample_ddp_cli_on_cpu(tmp_path):
    """5 images at batch 3: 6 sampled (the total rounded up), 6 PNGs named
    000000..000005, the npz holds the first 5 and equals the PNGs."""
    vae_bin = _vae_bin(tmp_path)
    args = cli.build_parser().parse_args(_flags(tmp_path, vae_bin, "--per-proc-batch-size", "3",
                                                "--num-fid-samples", "5", "--global-seed", "2"))
    res = cli.main(args)
    folder = tmp_path / "samples" / FOLDER.format(seed=2)
    assert res["sample_dir"] == str(folder) and res["images"] == 6
    assert sorted(os.listdir(folder)) == [f"{i:06d}.png" for i in range(6)]
    arr = np.load(res["npz"])["arr_0"]
    assert res["npz"] == f"{folder}.npz"
    assert arr.shape == (5, 64, 64, 3) and arr.dtype == np.uint8
    pngs = np.stack([_read_png(folder / f"{i:06d}.png") for i in range(6)])
    assert np.array_equal(arr, pngs[:5])
    # world 1, rank 0: seed 2 * 1 + 0, files in batch order
    want = np.concatenate(_expected(args, seed=2, batches=2))
    assert np.array_equal(pngs, want)
    assert pngs.std() > 0


def test_quantize_matches_jax():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(2, 3, 4, 5).astype(np.float32).ravel() * 1.5,
                        np.array([-2.0, -1.0, -1.0039216, 0.0, 0.9960784, 0.99999, 1.0, 3.0],
                                 np.float32)])
    x = np.resize(x, (2, 3, 4, 7)).astype(np.float32)
    want = np.asarray(jnp.clip(127.5 * jnp.asarray(x) + 128.0, 0, 255).astype(jnp.uint8))
    got = cli.quantize(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, 4, 7, 3)
    assert np.array_equal(got, want.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("flags", [
    # each case once paired a ported flag with one that was not; ToMe,
    # W8A8 and the MoE models are ported now (tests/test_torch_tome.py,
    # test_torch_quant.py, test_torch_moe.py), so every case runs, but for
    # the combination JAX itself refuses, which is refused with its message
    ["--sampler", "dpm", "--cache-interval", "2", "--quantize", "w8a8"],
    ["--sampler", "unipc", "--tome-ratio", "0.5"],
    ["--sampler", "euler", "--quantize", "w8a8"], ["--sampler", "heun", "--tome-mlp"],
    ["--time-spacing", "karras", "--cache-interval", "3", "--tome-ratio", "0.5"],
    ["--cfg-interval", "0.19", "1.61", "--tome-mlp"],
    ["--cache-interval", "2", "--tome-mlp"], ["--tome-ratio", "0.5"], ["--quantize", "w8a8"],
])
def test_flags_not_ported_are_refused(tmp_path, flags, monkeypatch):
    """The flag lists that were refused: JAX's refusal (dpm with the layer
    cache, `sample_ddp.py`'s assert) keeps its message and writes nothing;
    every other list builds the model it names and writes the npz."""
    args = cli.build_parser().parse_args(["--device", "cpu", "--ckpt", "random",
                                          "--model", "DiT-S/8", "--num-sampling-steps", "2",
                                          "--per-proc-batch-size", "2",
                                          "--num-fid-samples", "2",
                                          "--sample-dir", str(tmp_path), *flags])
    if "dpm" in flags and "--cache-interval" in flags:
        with pytest.raises(SystemExit, match=r"--cache-interval composes with ddpm/ddim; "
                                             r"dpm/unipc are already"):
            cli.main(args)
        assert os.listdir(tmp_path) == []
        return
    built = []
    monkeypatch.setattr(cli, "build_model", lambda *a, **k: built.append(build_model(*a, **k))
                        or built[-1])
    res = cli.main(args)
    (model,) = built
    assert model.tome_r == (8 if "--tome-ratio" in flags else 0)  # 16 tokens, ratio 0.5
    assert model.tome_mlp == ("--tome-mlp" in flags)
    assert (model.quant == "w8a8") == ("--quantize" in flags)
    arr = np.load(res["npz"])["arr_0"]
    assert res["images"] == 2 and arr.shape == (2, 32, 32, 3) and arr.std() > 0


# One rank of a gloo world: the CLI itself, world and rank from the environment.
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_world_of_two_strides_the_names(tmp_path):
    """Two processes at batch 2 (global batch 4) for 6 images: 8 sampled, rank
    r writes index i * 2 + r + 4k for its k-th batch, from seed 0 * 2 + r;
    rank 0 packs the first 6 after the barrier. Each rank runs 2 CPU
    threads, so its images are compared with `_near`."""
    vae_bin = _vae_bin(tmp_path)
    flags = _flags(tmp_path, vae_bin, "--per-proc-batch-size", "2", "--num-fid-samples", "6")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-m", "fast_dit_torch.sample_ddp", *flags],
                                      cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    assert "world_size=2" in logs[0] and "Saved .npz" in logs[0] and "Saved .npz" not in logs[1]
    folder = tmp_path / "samples" / FOLDER.format(seed=0)
    assert sorted(os.listdir(folder)) == [f"{i:06d}.png" for i in range(8)]
    args = cli.build_parser().parse_args(flags)
    for rank in range(2):
        want = _expected(args, seed=rank, batches=2)
        for k, batch in enumerate(want):
            for i, img in enumerate(batch):
                assert _near(_read_png(folder / f"{i * 2 + rank + 4 * k:06d}.png"), img)
    arr = np.load(f"{folder}.npz")["arr_0"]
    assert arr.shape == (6, 64, 64, 3)
    assert np.array_equal(arr, np.stack([_read_png(folder / f"{i:06d}.png") for i in range(6)]))
