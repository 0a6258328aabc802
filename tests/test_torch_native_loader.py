"""The port's binding to the C++ feature loader (fast_dit_torch/data/native_loader.py)
against the port's `feature_batches` and JAX's `NativeFeatureLoader`
(`fast_dit_tpu/data/native_loader.py`), and the trainer CLI with
`--native-loader`. Batches are compared exactly: the same files, order,
shards, dtypes and values."""

import os

import numpy as np
import pytest
import torch

from fast_dit_torch.data import FeatureDataset, NativeFeatureLoader, feature_batches
from fast_dit_torch.data import native_loader as nl
from fast_dit_torch.ops._build import BUILD_DIR
from fast_dit_torch.train import cli
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(root, n=11, shape=(1, 4, 4, 4), seed=0):
    """`n` extract_features-style pairs: {i}.npy (1, C, H, W) fp32 and a
    (1,) int64 label."""
    rs = np.random.RandomState(seed)
    fdir, ldir = root / "imagenet256_features", root / "imagenet256_labels"
    fdir.mkdir(parents=True)
    ldir.mkdir()
    for i in range(n):
        np.save(fdir / f"{i}.npy", rs.randn(*shape).astype(np.float32))
        np.save(ldir / f"{i}.npy", np.array([rs.randint(0, 1000)]))
    return str(fdir), str(ldir)


def _same(a, b):
    return (len(a) == len(b) and all(
        x["x"].dtype == y["x"].dtype and x["y"].dtype == y["y"].dtype
        and np.array_equal(x["x"], y["x"]) and np.array_equal(x["y"], y["y"])
        for x, y in zip(a, b)))


@pytest.mark.parametrize("shuffle,seed,procs", [(True, 3, 1), (False, 0, 1), (True, 5, 2)],
                         ids=["shuffled", "in-order", "two-processes"])
def test_batches_equal_feature_batches_and_jax(tmp_path, shuffle, seed, procs):
    from fast_dit_tpu.data.native_loader import NativeFeatureLoader as JaxNativeFeatureLoader

    fdir, ldir = _features(tmp_path)
    ds = FeatureDataset(fdir, ldir)
    for rank in range(procs):
        kw = dict(shuffle=shuffle, seed=seed, num_epochs=2, process_index=rank,
                  process_count=procs)
        got = list(NativeFeatureLoader(fdir, ldir, 4, num_threads=3, **kw))
        assert got[0]["x"].shape == (4 // procs, 4, 4, 4) and got[0]["y"].dtype == np.int32
        assert _same(got, list(feature_batches(ds, 4, **kw)))
        assert _same(got, list(JaxNativeFeatureLoader(fdir, ldir, 4, num_threads=3, **kw)))


def test_it_builds_into_the_build_directory_not_native():
    lib = nl.build_native_library()
    assert lib.parent == BUILD_DIR and lib.name.startswith("libfdt_dataloader-") and lib.exists()
    assert nl.SOURCE == BUILD_DIR.parent / "native" / "dataloader.cc"
    assert str(lib.parent) != os.path.join(REPO, "native")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "dataloader.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build the native loader"):
        nl.build_native_library(bad)
    good = tmp_path / "other.cc"
    good.write_text("int f() { return 0; }\n")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ at all
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        nl.build_native_library(good)


def test_trainer_cli_with_the_native_loader_reads_the_same_batches(tmp_path, monkeypatch):
    root = tmp_path / "features"
    _features(root, n=6, shape=(1, 4, 32, 32))
    flags = ["--device", "cpu", "--feature-path", str(root), "--model", "DiT-S/8",
             "--global-batch-size", "2", "--epochs", "2", "--log-every", "1"]
    native = cli.parse_args([*flags, "--native-loader"])
    python = cli.parse_args(flags)
    got = [[{k: v.numpy() for k, v in b.items()} for b in epoch]
           for epoch in cli.device_batches(native, torch.device("cpu"))]
    want = [[{k: v.numpy() for k, v in b.items()} for b in epoch]
            for epoch in cli.device_batches(python, torch.device("cpu"))]
    assert len(got) == 2 and all(_same(g, w) for g, w in zip(got, want))
    args = cli.parse_args([*flags, "--native-loader", "--max-steps", "2",
                           "--results-dir", str(tmp_path / "results")])
    cli.main(args)
    (exp,) = (tmp_path / "results").iterdir()
    log = (exp / "log.txt").read_text()
    assert "Using the native C++ feature loader" in log and log.count("Train Loss") == 2
