"""Where the sampler CLIs' `--ckpt` points (`fast_dit_torch/ckpt/download.py`,
the counterpart of `fast_dit_tpu/ckpt/download.py:24-53` and of
`sample.py:46-52`).

- `--ckpt <checkpoints dir>` of the port's trainer builds the same model as
  `--ckpt <dir>/<latest>.pt`, with the EMA weights, in `sample` and
  `sample_ddp` (after 2 trainer CLI steps of DiT-S/8, cut to 2 blocks).
- A state dict at `pretrained_models/DiT-XL-2-256x256.pt` in the working
  directory loads with and without `--ckpt` (the CLIs' default name), and
  a known name that is missing raises JAX's advice; nothing is downloaded
  (`tests/test_torch_sample.py::test_cli_never_downloads_a_checkpoint`
  holds the other paths).
"""

import functools

import pytest
import torch

from fast_dit_tpu.ckpt.download import pretrained_models as jax_pretrained_models
from fast_dit_torch import sample as cli
from fast_dit_torch import sample_ddp
from fast_dit_torch.ckpt import find_model, pretrained_models, resolve_model_path
from fast_dit_torch.models import DiT_models
from fast_dit_torch.train import cli as train_cli

from test_torch_world import drop_tmp_path, one_torch_thread  # noqa: F401 (autouse fixtures)


def _params(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_known_names_are_jaxs():
    assert pretrained_models == jax_pretrained_models


@pytest.mark.parametrize("prog", ["sample", "sample_ddp"])
def test_ckpt_dir_loads_the_latest_step_with_its_ema(prog, tmp_path, monkeypatch):
    monkeypatch.setitem(train_cli.DiT_models, "DiT-S/8",
                        functools.partial(DiT_models["DiT-S/8"], depth=2))
    train_cli.main(train_cli.parse_args([
        "--device", "cpu", "--synthetic-data", "--model", "DiT-S/8", "--global-batch-size",
        "2", "--max-steps", "2", "--ckpt-every", "1", "--log-every", "1", "--export-pt",
        "--results-dir", str(tmp_path / "r")]))
    (exp,) = (tmp_path / "r").iterdir()
    ckdir = exp / "checkpoints"
    # steps 1 and 2, and the EMA export of step 2, which a directory never picks
    assert sorted(p.name for p in ckdir.iterdir()) == ["0000001.pt", "0000002-ema.pt",
                                                       "0000002.pt"]
    assert resolve_model_path(str(ckdir)) == str(ckdir / "0000002.pt")
    parse = cli.parse_args if prog == "sample" else sample_ddp.build_parser().parse_args
    base = ["--device", "cpu", "--model", "DiT-S/8", "--num-classes", "1000"]
    by_dir = cli.build_model(parse(base + ["--ckpt", str(ckdir)]), torch.device("cpu"), 0)
    by_file = cli.build_model(parse(base + ["--ckpt", str(ckdir / "0000002.pt")]),
                              torch.device("cpu"), 0)
    a, b = _params(by_dir), _params(by_file)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    file = torch.load(ckdir / "0000002.pt", weights_only=False)
    assert all(torch.equal(a[k], file["ema"][k].float()) for k in a)
    assert any(not torch.equal(file["ema"][k], file["model"][k]) for k in file["ema"])


def test_known_name_loads_from_pretrained_models(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = DiT_models["DiT-S/2"](device="cpu", seed=5)
    (tmp_path / "pretrained_models").mkdir()
    torch.save({"ema": model.state_dict(), "model": {}},
               tmp_path / "pretrained_models" / "DiT-XL-2-256x256.pt")
    want = _params(model)
    for flags in ([], ["--ckpt", "DiT-XL-2-256x256.pt"]):
        args = cli.parse_args(["--device", "cpu", "--model", "DiT-S/2", *flags])
        got = _params(cli.build(args)[0])
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert set(find_model("DiT-XL-2-256x256.pt")) == set(want)
    with pytest.raises(FileNotFoundError, match="never downloads. Place the file manually at "
                                                "pretrained_models/DiT-XL-2-512x512.pt"):
        find_model("DiT-XL-2-512x512.pt")
    with pytest.raises(FileNotFoundError, match="no trainer checkpoint"):
        find_model(str(tmp_path / "pretrained_models"))
