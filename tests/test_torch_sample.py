"""The port's sampling slice as a whole, and its CLI, against the JAX package.

`test_cfg_sampling_slice_matches_jax` runs the main path of
`python -m fast_dit_torch.sample` at a small size: the same weights, noise
and per-step noise go through the JAX DiT (attn_backend="pallas", the
Pallas forward interpreted on the CPU) inside the JAX `p_sample_loop`, and
through the port's DiT (the attention twin on the CPU) inside the port's
loop, both over `forward_with_cfg` with CFG 4.0.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.utils.image import make_grid as jax_make_grid
from fast_dit_torch import sample as cli
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.diffusion import create_diffusion
from fast_dit_torch.models import DiT
from fast_dit_torch.utils.image import make_grid, save_image
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S2 = dict(input_size=8, patch_size=2, hidden_size=384, depth=2, num_heads=6)
# final latents of a 10-step fp32 chain, relative to max |JAX latents|; the
# measured error is 4.3e-4 against a max |x| of 509, i.e. 8.4e-7 relative
# (CPU, numpy seed 0)
SLICE_RTOL = 1e-4


def _jax_params(cfg, seed=0):
    model = JaxDiT(**cfg, attn_backend="pallas")
    n = cfg["input_size"]
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, n, n)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    return model, jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32), params)


def test_cfg_sampling_slice_matches_jax():
    jmodel, params = _jax_params(S2)
    model = DiT(**S2, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params, 2, 4, 8), strict=True)
    model.eval()

    labels = [207, 88]
    y = np.array(labels + [1000] * len(labels), np.int32)
    rs = np.random.RandomState(0)
    z = rs.randn(len(labels), 4, 8, 8).astype(np.float32)
    noise = np.concatenate([z, z])  # the CFG doubled batch [z; z]
    steps = 10
    step_noise = rs.randn(steps, *noise.shape).astype(np.float32)

    jdiff = jax_create_diffusion(str(steps))
    run = jax.jit(lambda p, n, sn: jdiff.p_sample_loop(
        lambda x, t: jmodel.apply(p, x, t, y, 4.0, method=jmodel.forward_with_cfg),
        n.shape, noise=n, step_noise=sn, clip_denoised=False))
    want = np.asarray(run(params, noise, step_noise))[: len(labels)]

    diffusion = create_diffusion(str(steps), device="cpu")
    ty = torch.from_numpy(y.astype(np.int64))
    with torch.inference_mode():
        got = diffusion.p_sample_loop(
            lambda x, t: model.forward_with_cfg(x, t, ty, 4.0), noise.shape,
            noise=torch.from_numpy(noise), step_noise=torch.from_numpy(step_noise),
            clip_denoised=False)[: len(labels)].numpy()
    assert got.shape == want.shape == (2, 4, 8, 8)
    assert np.isfinite(got).all() and np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= SLICE_RTOL * np.abs(want).max()


def _run_cli(cwd, *flags):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "fast_dit_torch.sample", *flags],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_runs_end_to_end_on_cpu(tmp_path):
    proc = _run_cli(tmp_path, "--device", "cpu", "--ckpt", "random", "--model", "DiT-S/2",
                    "--num-sampling-steps", "4")
    assert proc.returncode == 0, proc.stderr
    out = np.load(tmp_path / "sample.npy")
    assert out.shape == (len(cli.CLASS_LABELS), 4, 32, 32) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.std() > 0
    png = np.asarray(Image.open(tmp_path / "sample.png"))
    assert png.shape == (2 * 34 + 2, 4 * 34 + 2, 3)
    lo, hi = float(out.min()), float(out.max())
    assert np.array_equal(png, jax_make_grid(out[:, :3], nrow=4, value_range=(lo, hi)))


def test_cli_refuses_to_run_without_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    proc = _run_cli(tmp_path, "--ckpt", "random", "--model", "DiT-S/2",
                    "--num-sampling-steps", "2")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr and "--device cpu" in proc.stderr
    assert not (tmp_path / "sample.npy").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiT(input_size=8, hidden_size=32, depth=1, num_heads=4)


@pytest.mark.parametrize("flags", [
    ["--sampler", "ddim", "--attn-backend", "einsum"],
    ["--cfg-scale", "1.0"],  # no CFG: the 8 latents are sampled directly
])
def test_cli_sampling_variants_on_cpu(flags):
    args = cli.parse_args(["--device", "cpu", "--ckpt", "random", "--model", "DiT-S/2",
                           "--num-sampling-steps", "2", *flags])
    model, diffusion = cli.build(args)
    out = cli.sample_latents(args, model, diffusion)
    assert out.shape == (len(cli.CLASS_LABELS), 4, 32, 32)
    assert torch.isfinite(out).all() and out.std() > 0
    assert torch.equal(out, cli.sample_latents(args, model, diffusion))  # seeded


def test_cli_never_downloads_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = cli.parse_args(["--device", "cpu", "--model", "DiT-S/2", "--ckpt",
                           str(tmp_path / "missing.pt")])
    with pytest.raises(FileNotFoundError, match="never downloads"):
        cli.build(args)


@pytest.mark.parametrize("channels", [1, 3])
def test_png_writer_matches_the_jax_grid(tmp_path, channels):
    rs = np.random.RandomState(channels)
    imgs = rs.uniform(-1.2, 1.2, size=(5, channels, 6, 7)).astype(np.float32)
    want = jax_make_grid(imgs, nrow=4)
    assert np.array_equal(make_grid(imgs, nrow=4), want)
    save_image(imgs, str(tmp_path / "sub" / "grid.png"), nrow=4)
    got = np.asarray(Image.open(tmp_path / "sub" / "grid.png"))
    assert np.array_equal(got, want[..., 0] if channels == 1 else want)


def test_cli_decodes_with_a_vae_like_jax(tmp_path, monkeypatch):
    """With `--vae-ckpt` the CLI writes the grid of the decoded latents: the
    JAX VAE's decode of the port's latents, through the JAX grid, gives the
    same PNG up to one level in at most 1 % of the values (the two decodes
    agree within about 1e-5, which moves a value that sits within that of a
    rounding boundary of the 8-bit grid; measured: one level in 3.7e-5 of
    the values)."""
    from test_vae import make_vae_state_dict

    from fast_dit_tpu.ckpt.vae_import import vae_state_dict_to_flax
    from fast_dit_tpu.models.vae import AutoencoderKL as JaxVAE
    from fast_dit_tpu.models.vae import decode_from_latents as jax_decode_from_latents

    sd = make_vae_state_dict(0, (32, 64), 4)
    vae_bin = str(tmp_path / "vae.bin")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, vae_bin)
    monkeypatch.chdir(tmp_path)
    args = cli.parse_args(["--device", "cpu", "--ckpt", "random", "--model", "DiT-S/2",
                           "--num-sampling-steps", "3", "--vae-ckpt", vae_bin])
    cli.main(args)
    assert not (tmp_path / "sample.npy").exists()
    got = np.asarray(Image.open(tmp_path / "sample.png"))

    latents = cli.sample_latents(args, *cli.build(args)).numpy()  # seeded: the CLI's own
    jvae = JaxVAE(block_out_channels=(32, 64))
    params = jax.tree.map(jnp.asarray, vae_state_dict_to_flax(sd))
    images = np.asarray(jax_decode_from_latents(jvae, params, jnp.asarray(latents)))
    want = jax_make_grid(images, nrow=4, value_range=(-1, 1))
    assert got.shape == want.shape == (2 * 66 + 2, 4 * 66 + 2, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    assert 0 < got.std()


def test_cli_resolves_the_vae_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SD_VAE_PATH", raising=False)
    from fast_dit_torch.ckpt import resolve_vae_path

    args = cli.parse_args(["--device", "cpu", "--vae", "ema"])
    assert resolve_vae_path(args.vae_ckpt, args.vae) == "pretrained_models/sd-vae-ft-ema"
    assert cli.build_vae(args, torch.device("cpu")) is None
    monkeypatch.setenv("SD_VAE_PATH", "elsewhere/vae")
    assert resolve_vae_path(args.vae_ckpt, args.vae) == "elsewhere/vae"
    assert resolve_vae_path("mine.bin", "mse") == "mine.bin"
