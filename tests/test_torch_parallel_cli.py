"""The trainer CLI in a world of ranks: `python -m fast_dit_torch.train
--device cpu` under a torchrun-style environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, a free MASTER_PORT), two processes over gloo, with
DiT-S/8 cut to 2 blocks.

- `--fsdp` over 2 ranks equals one process with the same flags and global
  batch (the final checkpoint files, leaf by leaf, to JAX's limits:
  `tests/test_torch_data_parallel.py`), and rank 1 writes no file: the
  experiment dir holds rank 0's log and checkpoint only, and rank 1's
  working directory stays empty.
- A file written by the world of 2 resumes in one process, and a file
  written by one process resumes in a world of 2 with `--tp 2`; the two
  resumed runs, which continue equal states with the same batches, end
  equal.
- Half a world's environment raises before anything is written.
"""

import functools
import os
import socket
import subprocess
import sys

import pytest
import torch

from test_torch_world import REPO, assert_trees_close, drop_tmp_path, one_torch_thread  # noqa: F401

from fast_dit_torch.train import cli

ARGS = ["--device", "cpu", "--synthetic-data", "--model", "DiT-S/8", "--global-batch-size",
        "4", "--log-every", "1", "--fp32", "--global-seed", "3"]
_BOOT = (
    "import functools, sys\n"
    f"sys.path.insert(0, {REPO!r})\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from fast_dit_torch.train import cli\n"
    "cli.DiT_models['DiT-S/8'] = functools.partial(cli.DiT_models['DiT-S/8'], depth=2)\n"
    "cli.main(cli.parse_args(sys.argv[1:]))\n")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(n, argv, tmp_path, timeout=300):
    """`n` ranks of the CLI, each in its own empty working directory."""
    port = str(_free_port())
    procs, cwds = [], []
    for r in range(n):
        cwd = tmp_path / f"cwd{r}"
        cwd.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", _BOOT, *argv], cwd=cwd, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
        cwds.append(cwd)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    return cwds


def _one_process(argv, monkeypatch):
    monkeypatch.setitem(cli.DiT_models, "DiT-S/8",
                        functools.partial(cli.DiT_models["DiT-S/8"], depth=2))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    cli.main(cli.parse_args(argv))


def _ckpt(results, step):
    (exp,) = results.iterdir()
    return torch.load(exp / "checkpoints" / f"{step:07d}.pt", weights_only=False)


def _close(a, b):
    assert a["step"] == b["step"]
    assert torch.equal(a["rng"], b["rng"])
    assert_trees_close({k: a[k] for k in ("model", "ema", "opt")},
                       {k: b[k] for k in ("model", "ema", "opt")})


def test_world_of_two_cli_equals_one_process_and_resumes_across_worlds(tmp_path, monkeypatch):
    world, one = tmp_path / "world", tmp_path / "one"
    cwds = _torchrun(2, ARGS + ["--fsdp", "--max-steps", "2", "--results-dir", str(world)],
                     tmp_path / "a")
    _one_process(ARGS + ["--fsdp", "--max-steps", "2", "--results-dir", str(one)], monkeypatch)
    _close(_ckpt(world, 2), _ckpt(one, 2))
    # rank 0 alone wrote: one experiment dir with its log and one checkpoint
    (exp,) = world.iterdir()
    files = sorted(str(p.relative_to(exp)) for p in exp.rglob("*") if p.is_file())
    assert files == ["checkpoints/0000002.pt", "log.txt"]
    assert "Mesh: {'data': 2, 'model': 1} over 2 ranks" in (exp / "log.txt").read_text()
    assert not any(cwds[1].iterdir()) and not any(cwds[0].iterdir())

    # the world's file in one process; one process's file in a world of 2 (--tp 2)
    _one_process(ARGS + ["--max-steps", "4", "--resume", "--results-dir", str(world)],
                 monkeypatch)
    _torchrun(2, ARGS + ["--tp", "2", "--max-steps", "4", "--resume", "--results-dir",
                         str(one)], tmp_path / "b")
    for results in (world, one):
        (exp,) = results.iterdir()
        assert "Resumed from checkpoint at step 2" in (exp / "log.txt").read_text()
    _close(_ckpt(world, 4), _ckpt(one, 4))


@pytest.mark.parametrize("env", [{"RANK": "0"}, {"WORLD_SIZE": "2"}])
def test_cli_refuses_half_a_world_environment(env, tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="needs both"):
        cli.main(cli.parse_args(ARGS + ["--results-dir", str(tmp_path / "r")]))
    assert not (tmp_path / "r").exists()
