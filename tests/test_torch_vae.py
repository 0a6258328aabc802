"""The port's SD-VAE (fast_dit_torch/models/vae.py) and its weight import
(fast_dit_torch/ckpt/vae_import.py) against the JAX package's.

Both sides load the same random diffusers-format state dict
(`make_vae_state_dict`, tests/test_vae.py) or the same JAX param tree, take
the same numpy inputs and are compared in fp32. Tolerances are those the
JAX VAE is held to against its torch oracle (tests/test_vae.py): rtol 5e-4
and atol 5e-5 on the moments, rtol and atol 5e-4 on the images. Measured
(CPU): moments within 4e-6 (small) and 1e-5 (full width) of JAX, images
within 1.1e-5 and 4.6e-5, against max |out| of 4-14.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_vae import make_vae_state_dict

from fast_dit_tpu.ckpt.vae_import import load_vae_state_dict as jax_load_vae_state_dict
from fast_dit_tpu.ckpt.vae_import import vae_state_dict_to_flax
from fast_dit_tpu.models.vae import AutoencoderKL as JaxVAE
from fast_dit_tpu.models.vae import DiagonalGaussian as JaxGaussian
from fast_dit_tpu.models.vae import decode_from_latents as jax_decode_from_latents
from fast_dit_torch.ckpt import (flax_vae_to_state_dict, import_vae_checkpoint, load_vae,
                                 load_vae_state_dict, normalize_vae_state_dict)
from fast_dit_torch.models import (VAE_SCALE, AutoencoderKL, DiagonalGaussian,
                                   decode_from_latents, encode_to_latents)
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

SMALL = (32, 64)  # 2 stages: one downsample and one upsample
FULL = (128, 256, 512, 512)
MOMENTS_TOL = dict(rtol=5e-4, atol=5e-5)
IMAGE_TOL = dict(rtol=5e-4, atol=5e-4)


@functools.lru_cache(maxsize=None)
def _state_dict(channels, seed=0):
    """`make_vae_state_dict` once per process (read only)."""
    return make_vae_state_dict(seed, channels, 4)


def _port(sd, channels):
    vae = AutoencoderKL(channels, device="cpu")
    vae.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                        strict=True)
    return vae.eval()


def _jax_outputs(channels, params, x, z):
    vae = JaxVAE(block_out_channels=channels)
    moments = jax.jit(lambda p, x: vae.apply(p, x, method=vae.encode_moments))(params, x)
    images = jax.jit(lambda p, z: vae.apply(p, z, method=vae.decode))(params, z)
    return np.asarray(moments), np.asarray(images)


def _inputs(channels, size, seed=1):
    rs = np.random.RandomState(seed)
    f = 2 ** (len(channels) - 1)
    return (rs.randn(2, 3, size, size).astype(np.float32),
            rs.randn(2, 4, size // f, size // f).astype(np.float32))


@pytest.mark.parametrize("channels,size", [(SMALL, 16), (FULL, 32)], ids=["small", "full"])
def test_vae_matches_jax(channels, size):
    sd = _state_dict(channels)
    x, z = _inputs(channels, size)
    want_m, want_i = _jax_outputs(channels, jax.tree.map(jnp.asarray, vae_state_dict_to_flax(sd)),
                                  x, z)
    vae = _port(sd, channels)
    if channels == FULL:  # the kl-f8 VAE of sd-vae-ft-*: 83.7 M parameters
        n = sum(p.numel() for p in vae.parameters())
        assert 83_000_000 < n < 84_000_000, n
    with torch.inference_mode():
        got_m = vae.encode_moments(torch.from_numpy(x)).numpy()
        got_i = vae.decode(torch.from_numpy(z)).numpy()
    f = 2 ** (len(channels) - 1)
    assert got_m.shape == want_m.shape == (2, 8, size // f, size // f)
    assert got_i.shape == want_i.shape == (2, 3, size, size)
    np.testing.assert_allclose(got_m, want_m, **MOMENTS_TOL)
    np.testing.assert_allclose(got_i, want_i, **IMAGE_TOL)


def test_symmetric_downsample_padding_would_be_caught():
    """The (0, 1) pad matters: the same weights with the conv's own symmetric
    padding give the right shape and values far from JAX's."""
    sd = _state_dict(SMALL)
    x, _ = _inputs(SMALL, 16)
    want, _ = _jax_outputs(SMALL, jax.tree.map(jnp.asarray, vae_state_dict_to_flax(sd)), x,
                           np.zeros((1, 4, 8, 8), np.float32))
    vae = _port(sd, SMALL)
    down = vae.encoder.down_blocks[0].downsamplers[0]
    down.forward = lambda h: torch.nn.functional.conv2d(h, down.conv.weight, down.conv.bias,
                                                        stride=2, padding=1)
    with torch.inference_mode():
        got = vae.encode_moments(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 100 * 5e-4 * np.abs(want).max()


def test_jax_params_carry_across():
    """`flax_vae_to_state_dict` of a JAX `vae.init` gives the JAX outputs, and
    it inverts the JAX importer exactly."""
    jvae = JaxVAE(block_out_channels=SMALL)
    x, z = _inputs(SMALL, 16)
    params = jax.jit(jvae.init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, 16, 16)),
                                jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, params)
    want_m, want_i = _jax_outputs(SMALL, params, x, z)
    vae = AutoencoderKL(SMALL, device="cpu")
    vae.load_state_dict(flax_vae_to_state_dict(params), strict=True)
    with torch.inference_mode():
        np.testing.assert_allclose(vae.encode_moments(torch.from_numpy(x)).numpy(), want_m,
                                   **MOMENTS_TOL)
        np.testing.assert_allclose(vae.decode(torch.from_numpy(z)).numpy(), want_i, **IMAGE_TOL)

    for channels in (SMALL, FULL):
        sd = _state_dict(channels)
        back = flax_vae_to_state_dict(jax.tree.map(np.asarray, vae_state_dict_to_flax(sd)))
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert back[k].dtype == torch.float32 and np.array_equal(back[k].numpy(), v), k


def _legacy(sd, conv_attention=False):
    out = {}
    for k, v in sd.items():
        k2 = (k.replace("to_q.", "query.").replace("to_k.", "key.")
              .replace("to_v.", "value.").replace("to_out.0.", "proj_attn."))
        if conv_attention and k2 != k and k2.endswith(".weight"):
            v = v[:, :, None, None]  # the old 1x1-conv projections
        out[k2] = v
    return out


@pytest.mark.parametrize("conv_attention", [False, True], ids=["linear", "conv1x1"])
def test_legacy_attention_names_load_the_same_weights(tmp_path, conv_attention):
    sd = _state_dict(SMALL)
    legacy = _legacy(sd, conv_attention)
    assert set(legacy) != set(sd)
    path = str(tmp_path / "legacy.bin")
    torch.save({k: torch.from_numpy(v) for k, v in legacy.items()}, path)
    got = import_vae_checkpoint(path, AutoencoderKL(SMALL, device="cpu"))
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert normalize_vae_state_dict({k: torch.from_numpy(v) for k, v in legacy.items()}).keys() \
        == sd.keys()


def _write(fmt, sd, tmp_path):
    """Save `sd` as `fmt`; returns (path, the tensors as written)."""
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if fmt == "bin":
        path = str(tmp_path / "vae.bin")
        torch.save(tensors, path)
    elif fmt == "bin_nested":
        path = str(tmp_path / "vae.ckpt")
        torch.save({"state_dict": tensors}, path)
    elif fmt == "dir":
        os.makedirs(tmp_path / "sd-vae")
        path = str(tmp_path / "sd-vae")
        torch.save(tensors, os.path.join(path, "diffusion_pytorch_model.bin"))
    else:
        st = pytest.importorskip("safetensors.torch")
        dtype = {"safetensors_f32": torch.float32, "safetensors_f16": torch.float16,
                 "safetensors_bf16": torch.bfloat16}[fmt]
        tensors = {k: v.to(dtype).contiguous() for k, v in tensors.items()}
        path = str(tmp_path / "diffusion_pytorch_model.safetensors")
        st.save_file(tensors, path, metadata={"format": "pt"})
    return path, tensors


@pytest.mark.parametrize("fmt", ["bin", "bin_nested", "dir", "safetensors_f32",
                                 "safetensors_f16", "safetensors_bf16"])
def test_checkpoint_files_load_the_same_tensors_as_jax(tmp_path, fmt):
    sd = make_vae_state_dict(2, SMALL, 4)
    path, written = _write(fmt, sd, tmp_path)
    got = load_vae_state_dict(path)
    assert set(got) == set(written)
    for k, v in written.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    if fmt != "safetensors_bf16":  # numpy, which the JAX loader returns, has no bf16
        want = jax_load_vae_state_dict(path)
        assert set(want) == set(got)
        for k, v in want.items():
            assert np.array_equal(got[k].numpy(), v), k
    # and the model loads it, in fp32
    vae = load_vae(path, SMALL, device="cpu")
    assert torch.equal(vae.decoder.conv_out.weight, written["decoder.conv_out.weight"].float())


@pytest.mark.parametrize("channels", [SMALL, (32, 32, 32, 32), FULL], ids=["2", "4", "full"])
def test_load_vae_takes_the_checkpoint_widths(tmp_path, channels):
    path = str(tmp_path / "vae.bin")
    torch.save({k: torch.from_numpy(v) for k, v in _state_dict(channels).items()}, path)
    vae = load_vae(path, device="cpu")
    assert vae.block_out_channels == channels and vae.latent_channels == 4
    assert not vae.training
    other = (64, 64) if channels != (64, 64) else SMALL
    with pytest.raises(ValueError, match="VAE checkpoint mismatch"):
        load_vae(path, other, device="cpu")


def test_import_refuses_a_mismatched_checkpoint(tmp_path):
    sd = _state_dict(SMALL)
    bad = dict(sd)
    del bad["decoder.conv_out.bias"]
    bad["decoder.extra.weight"] = np.zeros(3, np.float32)
    bad["encoder.conv_in.weight"] = np.zeros((32, 3, 1, 1), np.float32)
    path = str(tmp_path / "bad.bin")
    torch.save({k: torch.from_numpy(v) for k, v in bad.items()}, path)
    with pytest.raises(ValueError) as e:
        import_vae_checkpoint(path, AutoencoderKL(SMALL, device="cpu"))
    msg = str(e.value)
    assert "missing=['decoder.conv_out.bias']" in msg and "decoder.extra.weight" in msg
    assert "encoder.conv_in.weight" in msg and "(32, 3, 3, 3)" in msg
    with pytest.raises(FileNotFoundError):
        load_vae_state_dict(str(tmp_path))  # a directory without weights


def test_diagonal_gaussian_and_latent_scale_match_jax():
    """With injected noise the port's sample is JAX's mean + std * eps, the
    encode scales by 0.18215 and the decode divides by it."""
    rs = np.random.RandomState(3)
    moments = rs.randn(2, 8, 4, 4).astype(np.float32) * 3
    moments[0, 4:, 0, 0] = [100.0, -100.0, 25.0, -35.0]  # past both clamps
    eps = rs.randn(2, 4, 4, 4).astype(np.float32)
    jd = JaxGaussian(jnp.asarray(moments.transpose(0, 2, 3, 1)))
    want = np.asarray(jd.mean + jd.std * jnp.asarray(eps.transpose(0, 2, 3, 1)))
    d = DiagonalGaussian(torch.from_numpy(moments))
    assert float(d.logvar.max()) == 20.0 and float(d.logvar.min()) == -30.0
    got = d.sample(noise=torch.from_numpy(eps)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(d.mode(), torch.from_numpy(moments[:, :4]))
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    assert torch.equal(d.sample(g1), d.sample(g2))
    assert not torch.equal(d.sample(g1), d.sample(torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError):
        d.sample()

    sd = _state_dict(SMALL)
    params = jax.tree.map(jnp.asarray, vae_state_dict_to_flax(sd))
    jvae = JaxVAE(block_out_channels=SMALL)
    vae = _port(sd, SMALL)
    x, _ = _inputs(SMALL, 16)
    eps = rs.randn(2, 4, 8, 8).astype(np.float32)
    jm = jvae.apply(params, jnp.asarray(x), method=jvae.encode_moments)
    jd = JaxGaussian(jnp.transpose(jm, (0, 2, 3, 1)))
    want_z = np.asarray(jd.mean + jd.std * jnp.asarray(eps.transpose(0, 2, 3, 1)))
    want_z = want_z.transpose(0, 3, 1, 2) * VAE_SCALE
    with torch.inference_mode():
        got_z = encode_to_latents(vae, torch.from_numpy(x), noise=torch.from_numpy(eps))
        got_img = decode_from_latents(vae, got_z).numpy()
    np.testing.assert_allclose(got_z.numpy(), want_z, **MOMENTS_TOL)
    want_img = np.asarray(jax_decode_from_latents(jvae, params, jnp.asarray(got_z.numpy())))
    np.testing.assert_allclose(got_img, want_img, **IMAGE_TOL)
    assert VAE_SCALE == 0.18215


def test_bf16_vae_stays_near_fp32():
    """bf16 convolutions and projections, fp32 GroupNorm statistics and
    softmax: within 5e-2 of max |out| of the fp32 model (measured 1e-2)."""
    sd = _state_dict(SMALL)
    x, z = _inputs(SMALL, 16)
    vae = _port(sd, SMALL)
    vae16 = AutoencoderKL(SMALL, dtype=torch.bfloat16, device="cpu")
    vae16.load_state_dict(vae.state_dict(), strict=True)
    with torch.inference_mode():
        for method, inp in (("encode_moments", x), ("decode", z)):
            want = getattr(vae, method)(torch.from_numpy(inp))
            got = getattr(vae16, method)(torch.from_numpy(inp))
            assert got.dtype == torch.float32 and torch.isfinite(got).all()
            assert (got - want).abs().max() <= 5e-2 * want.abs().max()


def test_random_vae_helper_is_the_diffusers_layout():
    """chip_smoke.py's numpy helper writes the names and shapes of the
    diffusers state dict, at the small and the full width."""
    import chip_smoke

    for channels in (SMALL, FULL):
        got = chip_smoke.random_vae_state_dict(channels, seed=0)
        want = _state_dict(channels)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        assert all(v.dtype == np.float32 for v in got.values())
