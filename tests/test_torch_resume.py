"""Checkpoints and `--resume` of the port's trainer (fast_dit_torch/ckpt/checkpoint.py,
fast_dit_torch/train/cli.py), as tests/test_checkpoint_resume.py holds the
JAX trainer's.

- k steps, save, restore into a state built from another seed, k more
  steps: equal, tensor for tensor, to 2k steps without a break, for every
  optimizer route and kind of nu, with the loss-second-moment sampler
  (warmed up, so that its history decides t) and the step's draws coming
  from the generator the checkpoint carries. Everything is deterministic
  on the CPU, so the comparison is exact.
- `latest_step`, retention and the file names beside `--export-pt`'s.
- `find_latest_experiment_dir` against JAX's.
- The CLI: a run, then `--resume`, which re-enters the dir, logs the step
  and continues the count; a restore into another route raises.
"""

import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

from fast_dit_tpu.utils.logging import find_latest_experiment_dir as jax_find_latest
from fast_dit_torch.ckpt import CheckpointManager
from fast_dit_torch.diffusion import LossSecondMomentState, create_diffusion
from fast_dit_torch.models import DiT
from fast_dit_torch.ops.fused_update import FactoredNu, FusedAdamWEmaState
from fast_dit_torch.train import cli, create_train_state, make_train_step
from fast_dit_torch.utils.logging import find_latest_experiment_dir, make_experiment_dir
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

# hidden 192: the factored route has factored and dense leaves (the JAX
# threshold is 65536 elements)
CFG = dict(input_size=8, patch_size=2, hidden_size=192, depth=2, num_heads=3, num_classes=10)
LR, K, B = 1e-4, 2, 4

ROUTES = {  # name: create_train_state flags
    "adamw": {},
    "mixed-precision": {"mixed_precision": True},
    "fused": {"fused_optimizer": True},
    "fused-nu-bf16": {"fused_optimizer": True, "nu_dtype": torch.bfloat16},
    "fused-factored": {"fused_optimizer": True, "factored_nu": True},
    "fused-factored-nu-bf16": {"fused_optimizer": True, "factored_nu": True,
                               "nu_dtype": torch.bfloat16},
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warm_sampler(seed=0):
    """A loss-second-moment state with every timestep's history full, so
    that it draws t by its history."""
    g = torch.Generator().manual_seed(seed)
    s = LossSecondMomentState.create(1000)
    return dataclasses.replace(s, loss_history=torch.rand(s.loss_history.shape, generator=g),
                               loss_counts=torch.full_like(s.loss_counts, s.history_per_term))


def _build(route, seed):
    model = DiT(**CFG, device="cpu", seed=seed)
    with torch.no_grad():  # the zero-initialised heads: give every leaf a gradient
        g = torch.Generator().manual_seed(seed + 100)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    gen = torch.Generator().manual_seed(seed + 200)
    flags = ROUTES[route]
    state = create_train_state(model, lr=None if flags.get("fused_optimizer") else LR,
                               sampler_state=_warm_sampler(seed), generator=gen, **flags)
    step = make_train_step(model, create_diffusion("", device="cpu").schedule, lr=LR,
                           generator=gen)
    return state, step


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    return {"x": torch.from_numpy(rs.randn(B, 4, 8, 8).astype(np.float32)),
            "y": torch.from_numpy(rs.randint(0, CFG["num_classes"], size=B).astype(np.int64))}


def _tensors(state) -> dict:
    """Every tensor of a train state, by a name."""
    out = {f"param {n}": p for n, p in state.model.named_parameters()}
    out.update({f"ema {n}": e for n, e in state.ema.items()})
    opt = state.opt
    if isinstance(opt, FusedAdamWEmaState):
        for i, (m, v, w) in enumerate(zip(opt.mu, opt.nu, opt.master)):
            out[f"mu {i}"], out[f"master {i}"] = m, w
            if isinstance(v, FactoredNu):
                out[f"nu {v.leaf.path} row"], out[f"nu {v.leaf.path} col"] = v.row, v.col
            else:
                out[f"nu {i}"] = v
    else:
        inner = getattr(opt, "inner", opt)
        for i, st in enumerate(inner.state.values()):
            for k, v in st.items():
                out[f"adam {i} {k}"] = v
        for i, w in enumerate(getattr(opt, "master", [])):
            out[f"master {i}"] = w
    out["sampler history"] = state.sampler_state.loss_history
    out["sampler counts"] = state.sampler_state.loss_counts
    out["generator"] = state.generator.get_state()
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_k_steps_save_restore_k_steps_equal_2k_steps(route, tmp_path):
    batch = _batch()
    straight, step = _build(route, seed=0)
    losses = [step(straight, batch)["loss"] for _ in range(2 * K)]

    first, step1 = _build(route, seed=0)
    for _ in range(K):
        step1(first, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(K, first, args={"route": route})
    resumed, step2 = _build(route, seed=7)  # another init and another generator
    assert mgr.restore(resumed) == K and resumed.step == K
    resumed_losses = [step2(resumed, batch)["loss"] for _ in range(K)]

    assert resumed.step == straight.step == 2 * K
    if isinstance(straight.opt, FusedAdamWEmaState):
        assert resumed.opt.count == straight.opt.count == 2 * K
    assert [v.item() for v in resumed_losses] == [v.item() for v in losses[K:]]
    want, got = _tensors(straight), _tensors(resumed)
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name


def test_the_file_keeps_the_reference_layout_and_adds_the_resume_state(tmp_path):
    state, step = _build("fused-factored", seed=0)
    step(state, _batch())
    path = CheckpointManager(str(tmp_path)).save(1, state, args={"a": 1})
    ckpt = torch.load(path, weights_only=False)
    assert set(ckpt) == {"model", "ema", "opt", "args", "step", "sampler", "rng"}
    model = DiT(**CFG, device="cpu")
    model.load_state_dict(ckpt["model"], strict=True)
    model.load_state_dict(ckpt["ema"], strict=True)
    assert ckpt["opt"]["route"] == "fused/factored" and ckpt["step"] == 1
    # row and col in JAX's shapes: (depth, D, 3, H) and (depth, D, 3, hd) for qkv
    qkv = ckpt["opt"]["factored"]["blocks/block/attn/qkv/kernel"]
    assert tuple(qkv["row"].shape) == (2, 192, 3, 3) and tuple(qkv["col"].shape) == (2, 192, 3, 64)
    proj = ckpt["opt"]["factored"]["blocks/block/attn/proj/kernel"]
    assert tuple(proj["row"].shape) == (2, 3, 64) and tuple(proj["col"].shape) == (2, 3, 192)


@pytest.mark.parametrize("saved,restored", [
    ("adamw", "mixed-precision"), ("fused", "fused-nu-bf16"), ("fused-nu-bf16", "fused"),
    ("fused", "fused-factored"), ("mixed-precision", "fused"),
    ("fused-factored", "fused-factored-nu-bf16"),
])
def test_a_restore_into_another_route_or_nu_kind_raises(saved, restored, tmp_path):
    state, _ = _build(saved, seed=0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    other, _ = _build(restored, seed=0)
    with pytest.raises(ValueError, match="optimizer state|does not fit"):
        mgr.restore(other)


def test_a_restore_with_another_timestep_sampler_raises(tmp_path):
    state, _ = _build("adamw", seed=0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    state.sampler_state = None
    with pytest.raises(ValueError, match="--schedule-sampler"):
        mgr.restore(state)


def test_latest_step_and_retention(tmp_path):
    state, _ = _build("adamw", seed=0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    (tmp_path / "ckpt" / "0000009-ema.pt").write_bytes(b"")  # --export-pt's file: not a step
    for s in (5, 10, 15):
        mgr.save(s, state)
    assert mgr.all_steps() == [10, 15] and mgr.latest_step() == 15
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "0000009-ema.pt", "0000010.pt", "0000015.pt"]
    keep_all = CheckpointManager(str(tmp_path / "all"))
    for s in (1, 2, 3):
        keep_all.save(s, state)
    assert keep_all.all_steps() == [1, 2, 3]


@pytest.mark.parametrize("made", [[], ["DiT-S/2"], ["DiT-S/2", "DiT-B/2", "DiT-S/2"],
                                  ["DiT-B/2"]])
def test_find_latest_experiment_dir_equals_jax(made, tmp_path):
    results = str(tmp_path / "results")
    for name in made:
        make_experiment_dir(results, name)
    (tmp_path / "results").mkdir(exist_ok=True)
    (tmp_path / "results" / "notes-DiT-S-2").mkdir()  # not an indexed dir
    assert find_latest_experiment_dir(results, "DiT-S/2") == jax_find_latest(results, "DiT-S/2")


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    """The CLI's DiT-S/8 cut to 2 blocks (each checkpoint file is then about
    0.1 GB, not 0.5), and the test's files removed after it."""
    monkeypatch.setitem(cli.DiT_models, "DiT-S/8",
                        functools.partial(cli.DiT_models["DiT-S/8"], depth=2))
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cli_args(tmp_path, *extra):
    return cli.parse_args(["--device", "cpu", "--synthetic-data", "--model", "DiT-S/8",
                           "--global-batch-size", "4", "--log-every", "1",
                           "--results-dir", str(tmp_path / "results"), *extra])


def test_cli_resume_reenters_the_dir_and_continues_the_count(small_cli):
    tmp_path = small_cli
    cli.main(_cli_args(tmp_path, "--max-steps", "2", "--ckpt-every", "1"))
    (exp,) = (tmp_path / "results").iterdir()
    assert CheckpointManager(str(exp / "checkpoints")).all_steps() == [1, 2]
    cli.main(_cli_args(tmp_path, "--max-steps", "3", "--resume"))
    assert [p.name for p in (tmp_path / "results").iterdir()] == [exp.name]
    log = (exp / "log.txt").read_text()
    assert "Resumed from checkpoint at step 2" in log
    assert "(step=0000003)" in log and log.count("Train Loss") == 3
    assert CheckpointManager(str(exp / "checkpoints")).latest_step() == 3
    ckpt = torch.load(exp / "checkpoints" / "0000003.pt", weights_only=False)
    assert ckpt["step"] == 3 and ckpt["args"].resume
    assert len(ckpt["model"]) == len(cli.DiT_models["DiT-S/8"](device="cpu").state_dict())


def test_cli_resume_restores_everything_and_restarts_the_data(small_cli):
    """1 step, then --resume for 1 more, equals 2 steps of the trainer's own
    functions on the first batch twice: every state is restored, and the
    data starts again at epoch 0, as JAX's trainer does (`train.py:126-156`)."""
    tmp_path = small_cli
    flags = ["--fused-optimizer", "--nu-dtype", "bf16", "--schedule-sampler",
             "loss-second-moment"]
    cli.main(_cli_args(tmp_path, "--max-steps", "1", *flags))
    cli.main(_cli_args(tmp_path, "--max-steps", "2", "--resume", *flags))
    (exp,) = (tmp_path / "results").iterdir()
    got = torch.load(exp / "checkpoints" / "0000002.pt", weights_only=False)

    args = _cli_args(tmp_path / "ref", "--max-steps", "2", *flags)
    _, _, state, train_step = cli.build(args)
    first = next(next(cli.device_batches(args, torch.device("cpu"))))
    for _ in range(2):
        train_step(state, first)
    want = CheckpointManager(str(tmp_path / "ref")).save(2, state)
    want = torch.load(want, weights_only=False)
    for key in ("model", "ema"):
        assert all(torch.equal(got[key][k], v) for k, v in want[key].items()), key
    assert all(torch.equal(g, w) for g, w in zip(got["opt"]["nu"], want["opt"]["nu"]))
    assert got["opt"]["nu"][0].dtype == torch.bfloat16 and got["opt"]["count"] == 2
    assert torch.equal(got["sampler"]["loss_history"], want["sampler"]["loss_history"])
    assert torch.equal(got["rng"], want["rng"])


def test_cli_resume_without_a_checkpoint_starts_fresh(small_cli):
    tmp_path = small_cli
    cli.main(_cli_args(tmp_path, "--max-steps", "1", "--resume"))
    (exp,) = (tmp_path / "results").iterdir()
    assert "Resumed" not in (exp / "log.txt").read_text()
    assert CheckpointManager(str(exp / "checkpoints")).latest_step() == 1


def test_cli_resume_into_another_route_raises(small_cli):
    tmp_path = small_cli
    cli.main(_cli_args(tmp_path, "--max-steps", "1"))
    with pytest.raises(ValueError, match="'adamw' optimizer state"):
        cli.main(_cli_args(tmp_path, "--max-steps", "2", "--resume", "--fused-optimizer"))
