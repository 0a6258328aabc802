"""The port's image pipeline (fast_dit_torch/data/imagenet.py), its PNG reader
(fast_dit_torch/utils/image.py) and its feature-extraction CLI
(`python -m fast_dit_torch.extract_features`) against the JAX package's.

The folder holds odd-sized JPEG and PNG files in two classes. The VAE is
a random diffusers-format one at 4 narrow stages (32 channels each), so 256²
crops give the (1, 4, 32, 32) features of the full model on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from test_vae import make_vae_state_dict

from fast_dit_tpu.data import ImageFolderIndex as JaxImageFolderIndex
from fast_dit_tpu.data import load_image as jax_load_image
from fast_dit_torch import extract_features as cli
from fast_dit_torch.ckpt import load_vae
from fast_dit_torch.data import FeatureDataset, ImageFolderIndex, center_crop_arr, load_image
from fast_dit_torch.train import cli as train_cli
from fast_dit_torch.utils.image import decode_png, encode_png
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = (32, 32, 32, 32)  # 4 stages: the kl-f8 factor of 8 at CPU cost


def _image_folder(root, per_class=3, seed=0):
    """Two classes of odd-sized RGB images, JPEG and PNG, one grey PNG."""
    rs = np.random.RandomState(seed)
    for c, name in enumerate(("n01", "n02")):
        os.makedirs(root / name)
        for i in range(per_class):
            h, w = rs.randint(257, 700), rs.randint(257, 700)
            arr = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
            if c == 1 and i == 0:
                Image.fromarray(arr[..., 0]).save(root / name / f"{i}.png")  # greyscale
            else:
                Image.fromarray(arr).save(root / name / f"{i}.{'png' if i % 2 else 'jpg'}")
    (root / "n01" / "notes.txt").write_text("not an image")
    return str(root)


def _vae_bin(tmp_path):
    path = str(tmp_path / "vae.bin")
    torch.save({k: torch.from_numpy(v) for k, v in make_vae_state_dict(0, NARROW, 4).items()},
               path)
    return path


def test_image_loading_matches_jax(tmp_path):
    root = _image_folder(tmp_path / "imgs")
    ours, theirs = ImageFolderIndex(root), JaxImageFolderIndex(root)
    assert ours.classes == theirs.classes == ["n01", "n02"]
    assert ours.samples == theirs.samples and len(ours) == 6
    for gi in range(len(ours)):
        path, _ = ours[gi]
        for hflip in (False, True):
            a = load_image(path, 256, hflip=hflip, rng=np.random.default_rng(gi))
            b = jax_load_image(path, 256, hflip=hflip, rng=np.random.default_rng(gi))
            assert a.shape == (3, 256, 256) and a.dtype == np.float32
            assert np.array_equal(a, b)
    with Image.open(ours[0][0]) as img:
        assert center_crop_arr(img.convert("RGB"), 64).size == (64, 64)


@pytest.mark.parametrize("shape", [(5, 7), (6, 9, 3), (1, 1, 3), (3, 4, 1)])
def test_png_round_trip(shape):
    x = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    want = x[..., 0] if shape[-1] == 1 else x
    assert np.array_equal(decode_png(encode_png(x)), want)


def test_png_reader_refuses_other_forms(tmp_path):
    rs = np.random.RandomState(1)
    smooth = np.tile(np.arange(64, dtype=np.uint8), (32, 1))  # Pillow filters these rows
    forms = {"filtered": Image.fromarray(np.stack([smooth] * 3, -1)),
             "palette": Image.fromarray(rs.randint(0, 256, (8, 8, 3)).astype(np.uint8)).convert("P"),
             "rgba": Image.fromarray(rs.randint(0, 256, (8, 8, 4)).astype(np.uint8))}
    for name, img in forms.items():
        img.save(tmp_path / f"{name}.png")
        with pytest.raises(ValueError):
            decode_png((tmp_path / f"{name}.png").read_bytes())
    with pytest.raises(ValueError):
        decode_png(b"GIF89a")
    good = bytearray(encode_png(np.zeros((4, 4, 3), np.uint8)))
    good[-20] ^= 0xFF  # a damaged IDAT
    with pytest.raises(ValueError):
        decode_png(bytes(good))


def test_extract_features_cli_on_cpu(tmp_path, monkeypatch):
    root = _image_folder(tmp_path / "imgs")
    vae_bin = _vae_bin(tmp_path)
    feats = tmp_path / "features"
    cli.main(cli.build_parser().parse_args([
        "--device", "cpu", "--data-path", root, "--features-path", str(feats),
        "--vae-ckpt", vae_bin, "--batch-size", "4", "--global-seed", "3"]))
    feat_dir, label_dir = cli.feature_dirs(str(feats), 256)
    assert sorted(os.listdir(feat_dir)) == sorted(os.listdir(label_dir)) == \
        [f"{i}.npy" for i in range(6)]
    index = JaxImageFolderIndex(root)
    for gi in range(6):
        assert np.array_equal(np.load(f"{label_dir}/{gi}.npy"), np.array([index[gi][1]]))

    # the port's encode of JAX's loaded images, in the CLI's batches, with the
    # generator of process seed 3 * 1 + 0
    vae = load_vae(vae_bin, device="cpu")
    assert vae.block_out_channels == NARROW
    g = torch.Generator().manual_seed(3)
    for chunk in ([0, 1, 2, 3], [4, 5]):
        x = np.stack([jax_load_image(index[gi][0], 256, hflip=True,
                                     rng=np.random.default_rng(3 * 1_000_003 + gi))
                      for gi in chunk])
        want = cli.encode_images(vae, torch.from_numpy(x), g).numpy()
        for j, gi in enumerate(chunk):
            got = np.load(f"{feat_dir}/{gi}.npy")
            assert got.shape == (1, 4, 32, 32) and got.dtype == np.float32
            np.testing.assert_allclose(got[0], want[j], rtol=1e-6, atol=1e-7)

    ds = FeatureDataset(feat_dir, label_dir)
    assert len(ds) == 6
    # the port's trainer takes one step on the extracted features
    monkeypatch.chdir(tmp_path)
    train_cli.main(train_cli.parse_args([
        "--device", "cpu", "--feature-path", str(feats), "--model", "DiT-S/2",
        "--global-batch-size", "2", "--max-steps", "1", "--log-every", "1",
        "--epochs", "1"]))
    runs = os.listdir(tmp_path / "results")
    assert len(runs) == 1 and os.listdir(tmp_path / "results" / runs[0] / "checkpoints")


def test_extract_features_needs_weights(tmp_path):
    root = _image_folder(tmp_path / "imgs", per_class=1)
    args = cli.build_parser().parse_args([
        "--device", "cpu", "--data-path", root, "--features-path", str(tmp_path / "f"),
        "--vae-ckpt", str(tmp_path / "missing.bin")])
    with pytest.raises(FileNotFoundError, match="SD-VAE weights not found"):
        cli.main(args)


@pytest.mark.parametrize("module,flags", [
    ("fast_dit_torch.extract_features", ["--data-path", "."]),
    ("fast_dit_torch.sample_ddp", ["--ckpt", "random", "--num-fid-samples", "1"]),
])
def test_cli_refuses_to_run_without_cuda_unless_asked(tmp_path, module, flags):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", module, *flags], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr and "--device cpu" in proc.stderr
    assert os.listdir(tmp_path) == []


def test_decode_and_encode_run_with_tf32_off():
    """The sampler's decode and the extractor's encode set TF32 off for
    themselves, whatever the caller's setting, and restore it after."""
    from fast_dit_torch import sample

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.Parameter(torch.zeros(1))

        def decode(self, z):
            seen.append(flags())
            return z

        def encode_moments(self, x):
            seen.append(flags())
            return torch.zeros(x.shape[0], 8, 2, 2)

    saved = flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        sample.decode(Probe(), torch.zeros(1, 4, 2, 2))
        cli.encode_images(Probe(), torch.zeros(1, 3, 16, 16), torch.Generator())
        assert seen == [(False, False)] * 2 and flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
