"""The port's ground-truth crop (fast_dit_torch/crop_gt.py) against JAX's
`center_crop_arr` (`fast_dit_tpu/data/imagenet.py`) and `tools/crop_gt.py`:
every output image equal pixel for pixel, on images that take the BOX
halving branch (short side at least twice the target) and on images that do
not (larger and smaller than the target); files that are not images are
skipped; without Pillow the CLI stops with a clear message.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
from PIL import Image

from fast_dit_torch import crop_gt
from fast_dit_tpu.data import center_crop_arr as jax_center_crop_arr
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
# (width, height): halved twice, halved once, only resized down, resized up
SHAPES = {"halve2.png": (150, 131), "halve1.png": (70, 97), "down.png": (45, 40),
          "up.bmp": (20, 27)}


def _folder(path):
    rs = np.random.RandomState(0)
    path.mkdir()
    for name, (w, h) in SHAPES.items():
        Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(path / name)
    (path / "notes.txt").write_text("not an image")
    return path


def _jax_crop_gt():
    spec = importlib.util.spec_from_file_location(
        "jax_crop_gt", os.path.join(REPO, "tools", "crop_gt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_crops_equal_jax_center_crop_pixel_for_pixel(tmp_path, capsys):
    src = _folder(tmp_path / "gt")
    assert crop_gt.main(["--input", str(src), "--image-size", str(SIZE)]) == 0
    out = tmp_path / "gt_cropped"  # the default output folder, as in JAX
    assert sorted(os.listdir(out)) == sorted(SHAPES)
    assert capsys.readouterr().out.strip() == f"cropped {len(SHAPES)} images -> {out}"
    for name in SHAPES:
        got = np.asarray(Image.open(out / name))
        want = np.asarray(jax_center_crop_arr(Image.open(src / name).convert("RGB"), SIZE))
        assert got.shape == (SIZE, SIZE, 3)
        assert np.array_equal(got, want), name


def test_output_equals_the_jax_tool(tmp_path, monkeypatch):
    src = _folder(tmp_path / "gt")
    crop_gt.main(["--input", str(src), "--output", str(tmp_path / "port"),
                  "--image-size", str(SIZE)])
    monkeypatch.setattr(sys, "argv", ["crop_gt.py", "--input", str(src), "--output",
                                      str(tmp_path / "jax"), "--image-size", str(SIZE)])
    _jax_crop_gt().main()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in SHAPES:
        assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                              np.asarray(Image.open(tmp_path / "jax" / name))), name


def test_without_pillow_it_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)  # `import PIL` raises ImportError
    with pytest.raises(SystemExit, match="Pillow is not installed"):
        crop_gt.main(["--input", str(tmp_path)])
