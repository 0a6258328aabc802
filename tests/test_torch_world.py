"""Spawned gloo worlds for the port's parallel tests, the rank-side training
program they run, and the tests of the collectives
(`fast_dit_torch/parallel/collectives.py`) and of `utils/platform.py`.

`spawn_world(n, fn, tmp_path, **kwargs)` starts n Python processes. Each
blocks JAX's packages from import, joins a gloo group of n ranks through a
`FileStore` file under `tmp_path` (no ports, so parallel test workers cannot
collide), runs `fn` (a function of this module) with `kwargs` and saves its
result; the parent returns the results in rank order. Every spawn has its
own timeout (300 s): a hang fails the test and the children are killed.
The world's directory (its job, store, logs and results) is removed once
the results are read, pass or fail, and the autouse `drop_tmp_path`, which
every port test file that writes under `tmp_path` imports, removes a
test's `tmp_path` when it ends: the CLI tests leave checkpoints, exported
weights and feature folders of hundreds of MB that nothing reads later,
and pytest keeps the directories of the last three runs.
This module imports no JAX, so the ranks import only torch, numpy and the
port.

`pipeline_run` and `pipefusion_run` drive a small DiT through the
pipeline and PipeFusion on the stages they are given, or on this rank of a
spawned world as a `ProcessGroupStages` rank that holds only its own
blocks, so the tests compare the two.

`train_route(route, mesh)` trains one route, a dict of the model's config,
its weights, the mesh, the optimizer route, the step's options, the global
batches and, optionally, injected draws: on a mesh (a rank of a spawned
world, through `parallel.mesh.shard_params` and
`train.make_sharded_train_step`), or, with `mesh=None`, as one process on
the global batch. It returns the metrics of every step, the gathered
checkpoint tree (`ckpt.checkpoint.checkpoint_tree`, full tensors) and each
rank's local tensors, so the tests can compare a world with one process
leaf by leaf and ranks with each other bit for bit.
"""

import fcntl
import math
import os
import shutil
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fast_dit_torch.ckpt.checkpoint import checkpoint_tree
from fast_dit_torch.diffusion import LossSecondMomentState, create_diffusion
from fast_dit_torch.models import DiT
from fast_dit_torch.nvs import DiTNVS
from fast_dit_torch.parallel import collectives as col
from fast_dit_torch.parallel.mesh import (batch_rows, create_expert_mesh, create_mesh,
                                          shard_params)
from fast_dit_torch.parallel.pipefusion import (init_kv_cache, pipefusion_forward,
                                                pipefusion_sample_loop)
from fast_dit_torch.parallel.pipeline import (ProcessGroupStages, create_pipeline_groups,
                                              dit_pipeline_forward, keep_own_blocks)
from fast_dit_torch.sample import perturb_
from fast_dit_torch.train import create_train_state, make_train_step
from fast_dit_torch.train.train_lib import make_sharded_train_step
from fast_dit_torch.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# JAX's limits for its sharded step (tests/test_parallel.py:116-123)
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
RTOL, ATOL = 2e-3, 2e-5
LR, DECAY = 1e-4, 0.9999
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "fast_dit_tpu")

_BOOT = f"""
import os, sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "tests")!r}]
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, job, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
import test_torch_world as w
spec = torch.load(job, weights_only=False)
res = getattr(w, spec["fn"])(**spec["kwargs"])
torch.save(res, out + ".tmp")
os.replace(out + ".tmp", out)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as the other port tests pin it: the
    suite runs under several xdist workers, and the worlds add processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    """Remove the test's `tmp_path`, if it has one, when it ends."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def spawn_world(n, fn, tmp_path, timeout=TIMEOUT, **kwargs):
    """Run `fn(**kwargs)` on every rank of a gloo world of n processes;
    returns the ranks' results in order."""
    d = tmp_path / f"world-{fn}-{uuid.uuid4().hex[:8]}"
    d.mkdir(parents=True)
    job = d / "job.pt"
    torch.save({"fn": fn, "kwargs": kwargs}, job)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    logs = [open(d / f"log{r}.txt", "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", _BOOT, str(r), str(n), str(d / "store"),
                               str(job), str(d / f"out{r}.pt")], env=env, cwd=str(d),
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    try:
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            text = "\n".join(f"--- rank {r} (rc {procs[r].returncode}):\n"
                             + (d / f"log{r}.txt").read_text()[-4000:] for r in bad)
            raise AssertionError(f"world of {n} running {fn} failed or timed out after "
                                 f"{timeout} s:\n{text}")
        return [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def shared_world(tmp_path_factory, key, n, fn, **kwargs):
    """`spawn_world` once per test run for `key`, whichever xdist worker
    asks first: a module's parametrised cases spread over the workers, and
    each worker would otherwise start the same world again. The others wait
    on a file lock and read the saved results."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, shared by its workers
    done = root / f"world-{key}.pt"
    with open(root / f"world-{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            res = spawn_world(n, fn, root / f"world-{key}", **kwargs)
            torch.save(res, done)
    return torch.load(done, weights_only=False)


# -- the rank-side training program ----------------------------------------

def small_model(cfg, weights=None):
    """A small DiT from `cfg` (DiT kwargs; a DiTNVS where they name a
    `dino_dim`), with `weights` (a state dict) or the seed-0 init perturbed
    by `sample.perturb_`."""
    model = (DiTNVS if "dino_dim" in cfg else DiT)(**cfg, device="cpu", seed=0)
    if weights is None:
        perturb_(model)
    else:
        model.load_state_dict(weights, strict=True)
    return model


def _mesh(route):
    inner, size = route.get("inner", ("model", 1))
    return create_expert_mesh(size) if inner == "expert" else create_mesh(model=size)


def _sampler(route):
    hist = route.get("sampler")
    if hist is None:
        return None
    s = LossSecondMomentState.create(1000)
    return LossSecondMomentState(torch.from_numpy(hist), torch.full_like(s.loss_counts, 10),
                                 1000, 10, s.uniform_prob)


def train_route(route, mesh="world"):
    """Train `route` for len(route["batches"]) steps (see the module
    docstring); `mesh` "world" (this rank of a spawned world, on the
    route's mesh) or None (one process, the global batch)."""
    model = small_model(route["model"], route.get("weights"))
    if mesh == "world":
        mesh = _mesh(route)
        shard_params(model, mesh, tp=route.get("tp", False), fsdp=route.get("fsdp", False))
    g = torch.Generator().manual_seed(route.get("seed", 0))
    state_kw = dict(route.get("state", {}))
    fused = state_kw.get("fused_optimizer", False)
    state = create_train_state(model, lr=None if fused else 1e-4, generator=g,
                               sampler_state=_sampler(route), **state_kw)
    step_kw = dict(lr=1e-4, log_grad_norm=True, generator=g, **route.get("step", {}))
    if isinstance(model, DiTNVS):
        step_kw["model_call"] = nvs_model_call(model)
    schedule = create_diffusion("", device="cpu").schedule
    step = (make_train_step(model, schedule, **step_kw) if mesh is None else
            make_sharded_train_step(model, schedule, mesh, **step_kw))
    keeps = []
    if getattr(model, "moe_experts", 0):
        # the kept (choice, token) slots of block 0's first forward
        def grab(module, inputs, output):
            if not keeps:
                with torch.no_grad():  # saves nothing for a remat region's backward
                    keeps.append(module.route(inputs[0]).keep.clone())
        model.blocks[0].mlp.register_forward_hook(grab)
    metrics = []
    for i, b in enumerate(route["batches"]):
        rows = slice(None) if mesh is None else batch_rows(mesh, len(b["y"]))
        batch = {k: torch.from_numpy(v[rows]) for k, v in b.items()}
        draws = None if route.get("draws") is None else [
            {k: torch.from_numpy(v) for k, v in d.items()} for d in route["draws"][i]]
        m = step(state, batch, draws=draws)
        metrics.append({k: v.item() for k, v in m.items()})
    tree = checkpoint_tree(state)
    out = {"metrics": metrics, "tree": tree, "state_bytes": _state_bytes(state),
           "keep": keeps[0] if keeps else None}
    if mesh is not None:
        sharding = model.sharding
        out["rank"], out["data_rank"], out["inner_rank"] = (mesh.rank, mesh.data_rank,
                                                            mesh.inner_rank)
        out["local"] = {s.name: p.detach().clone() for s, p in zip(sharding.shards,
                                                                   model.parameters())}
        out["keys"] = {s.name: (s.data_sharded, s.inner_sharded) for s in sharding.shards}
        out["split"] = {s.name: math.prod(s.full_shape) // max(p.numel(), 1)
                        for s, p in zip(sharding.shards, model.parameters())}
        out["sampler"] = (None if state.sampler_state is None else
                          state.sampler_state.loss_history.clone())
    return out


def nvs_model_call(model):
    """The train step's `model_call` for a DiTNVS: the batch's DINO features."""
    def call(x_t, t, batch, force_drop_ids, generator):
        return model(x_t, t, batch["dino_feat"], batch["y"], train=True,
                     force_drop_ids=force_drop_ids, generator=generator)
    return call


def _state_bytes(state):
    """Bytes of this rank's parameters, EMA and optimizer tensors."""
    ts = list(state.model.parameters()) + list(state.ema.values())
    opt = state.opt
    for key in ("mu", "master"):
        ts += list(getattr(opt, key, []))
    for v in getattr(opt, "nu", []):
        ts += [v.row, v.col] if hasattr(v, "row") else [v]
    inner = getattr(opt, "inner", opt)
    if hasattr(inner, "state") and isinstance(inner.state, dict):
        for st in inner.state.values():
            ts += [v for v in st.values() if torch.is_tensor(v) and v.dim()]
    seen, total = set(), 0
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def run_routes(routes):
    """Every route on this rank, one after another: {name: result}."""
    return {r["name"]: train_route(r) for r in routes}


def assert_replicas_equal(results):
    """Ranks that hold the same part of a parameter (a replicated leaf, or
    the same shard) hold it bit for bit equal."""
    names = results[0]["keys"]
    for name, (data_sharded, inner_sharded) in names.items():
        groups = {}
        for res in results:
            key = (res["data_rank"] if data_sharded else None,
                   res["inner_rank"] if inner_sharded else None)
            groups.setdefault(key, []).append(res["local"][name])
        for ts in groups.values():
            assert all(torch.equal(ts[0], t) for t in ts[1:]), name


def _bf16_ulp(x):
    return 2.0 ** (torch.floor(torch.log2(x.abs() + 1e-30)) - 7)


def assert_trees_close(got, want, bf16_grads=False, steps=2):
    """Two checkpoint trees elementwise, to the limits that
    tests/test_torch_data_parallel.py states (JAX's own on fp32 routes;
    Adam's on parameters whose gradients are bf16); returns the largest
    absolute error seen."""
    stats = {"worst": 0.0, "over": 0, "params": 0, "adam_step": 2 * LR * steps}
    _close(got, want, bf16_grads, "", stats)
    # the parameters and masters past JAX's limits, over all of them
    assert stats["over"] <= 1e-3 * stats["params"], stats
    return stats["worst"]


def _close(got, want, bf16_grads, path, stats):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], bf16_grads, f"{path}.{k}" if path else k, stats)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, bf16_grads, f"{path}.{i}", stats)
    elif torch.is_tensor(want):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if not want.is_floating_point():
            assert torch.equal(got, want), path
            return
        if not want.numel():
            return
        w = want.double()
        err = (got.double() - w).abs()
        jax_lim = ATOL + RTOL * w.abs()
        if not bf16_grads:
            lim = jax_lim
        elif path.startswith(("model", "opt.master")):
            lim = torch.clamp(jax_lim, min=stats["adam_step"])
            stats["over"] += int((err > jax_lim).sum())
            stats["params"] += err.numel()
        elif path.startswith("ema"):
            lim = jax_lim + stats["adam_step"] * (1 - DECAY)
        else:  # an optimizer moment
            lim = ATOL + 2 * _bf16_ulp(w.abs().max())
        assert bool((err <= lim).all()), (path, err.max().item())
        stats["worst"] = max(stats["worst"], err.max().item())


def assert_metrics_close(got, want, bf16_grads=False):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            # the norm of bf16 gradients: one bf16 rounding (as in
            # tests/test_torch_train.py)
            rtol = 2 ** -8 if bf16_grads and k == "grad_norm" else LOSS_RTOL
            assert abs(g[k] - w[k]) <= LOSS_ATOL + rtol * abs(w[k]), (k, g[k], w[k])


# -- the collectives --------------------------------------------------------

def _collectives_rank():
    world, rank = dist.get_world_size(), dist.get_rank()
    g = dist.group.WORLD
    out = {}
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out["all_reduce"] = col.all_reduce(x.clone(), g)
    out["all_gather1"] = col.all_gather(x, g, dim=1)
    out["reduce_scatter0"] = col.reduce_scatter(torch.arange(4.0).reshape(4, 1) * (rank + 1),
                                                g, dim=0)
    out["broadcast"] = col.broadcast(x.clone(), 1, g)
    out["bf16_sum"] = col.all_reduce(torch.full((3,), 1.0 + rank, dtype=torch.bfloat16), g)
    out["bf16_gather"] = col.all_gather(torch.full((1, 2), 1.0 + rank / 128,
                                                   dtype=torch.bfloat16), g, dim=0)
    # autograd: d/dx of sum(w * f(x)) for each function
    w = torch.arange(1.0, 7.0).reshape(2, 3)
    grads = {}
    for name, fn in (("copy", lambda t: col.copy_to_group(t, g)),
                     ("reduce", lambda t: col.reduce_from_group(t, g)),
                     ("mean", lambda t: col.mean_over_group(t, g)),
                     ("gather", lambda t: col.gather_shard(t, g, 1)),
                     ("owned", lambda t: col.broadcast_owned(t, g, 0, (2, 3)))):
        t = (x if name != "owned" or rank == 0 else x.new_empty(0)).clone().requires_grad_()
        y = fn(t)
        (y * (w if y.shape == w.shape else torch.ones_like(y))).sum().backward()
        grads[name] = (y.detach(), t.grad)
    out["grads"] = grads
    out["string"] = platform.broadcast_string("exp-dir/001" if rank == 0 else None)
    mesh = create_mesh(model=2)
    out["mesh"] = (mesh.data_rank, mesh.inner_rank,
                   col.all_gather(torch.tensor([rank]), mesh.data_group).tolist(),
                   col.all_gather(torch.tensor([rank]), mesh.inner_group).tolist())
    return out


def test_collectives_in_a_gloo_world_of_four(tmp_path):
    res = spawn_world(4, "_collectives_rank", tmp_path)
    xs = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r for r in range(4)]
    total = sum(xs)
    for r, out in enumerate(res):
        assert torch.equal(out["all_reduce"], total)
        assert torch.equal(out["all_gather1"], torch.cat(xs, dim=1))
        assert torch.equal(out["reduce_scatter0"], torch.tensor([[10.0 * r]]))
        assert torch.equal(out["broadcast"], xs[1])
        # bf16 goes to gloo as it is
        assert out["bf16_sum"].dtype == torch.bfloat16
        assert torch.equal(out["bf16_sum"], torch.full((3,), 10.0).bfloat16())
        assert torch.equal(out["bf16_gather"], (1 + torch.arange(4.0)[:, None] / 128)
                           .expand(4, 2).bfloat16())
        w = torch.arange(1.0, 7.0).reshape(2, 3)
        y, gx = out["grads"]["copy"]
        assert torch.equal(y, xs[r]) and torch.equal(gx, 4 * w)
        y, gx = out["grads"]["reduce"]
        assert torch.equal(y, total) and torch.equal(gx, w)
        y, gx = out["grads"]["mean"]
        assert torch.equal(y, total / 4) and torch.equal(gx, w)
        y, gx = out["grads"]["gather"]
        assert torch.equal(y, torch.cat(xs, dim=1)) and torch.equal(gx, 4 * torch.ones(2, 3))
        y, gx = out["grads"]["owned"]
        assert torch.equal(y, xs[0])
        assert torch.equal(gx, 4 * w) if r == 0 else gx.numel() == 0
        assert out["string"] == "exp-dir/001"
        # model innermost: consecutive ranks share a model group
        assert out["mesh"] == (r // 2, r % 2, [r % 2, r % 2 + 2], [2 * (r // 2), 2 * (r // 2) + 1])


@pytest.mark.parametrize("env", [{"RANK": "0"}, {"WORLD_SIZE": "2"}])
def test_half_a_world_environment_raises(env, monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="needs both"):
        platform.maybe_initialize_distributed(torch.device("cpu"))


def test_no_world_is_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    dev = torch.device("cpu")
    assert platform.maybe_initialize_distributed(dev) == (1, 0, dev)
    assert platform.broadcast_string("a") == "a" and platform.broadcast_string(None) == ""
    mesh = create_mesh()
    assert (mesh.shape, mesh.data_group, mesh.inner_group) == ({"data": 1, "model": 1},
                                                               None, None)
    x = torch.ones(3)
    assert col.all_reduce(x, None) is x and col.copy_to_group(x, None) is x


def batches(rs, n, steps, classes=10, size=8):
    return [{"x": rs.randn(n, 4, size, size).astype(np.float32),
             "y": rs.randint(0, classes, size=n).astype(np.int64)} for _ in range(steps)]


# -- the rank-side pipeline and PipeFusion programs --------------------------

def world_stages():
    """This rank's stage of a pipeline over the whole spawned world."""
    pipe_group, _ = create_pipeline_groups(dist.get_world_size())
    return ProcessGroupStages(pipe_group)


def stage_model(cfg, weights, stages):
    """`small_model(cfg, weights)` holding only the blocks of its stage."""
    model = small_model(cfg, weights)
    keep_own_blocks(model, stages)
    return model


def pipeline_run(cfg, weights, inputs, microbatches, stages=None, grad=True):
    """`dit_pipeline_forward` of `inputs` (numpy x, t, y) on `stages` (None:
    this rank of the spawned world); with `grad`, also d sum(out^2) / d
    every parameter this rank holds that got a gradient."""
    stages = world_stages() if stages is None else stages
    model = stage_model(cfg, weights, stages)
    x, t, y = (torch.from_numpy(a) for a in inputs)
    with torch.set_grad_enabled(grad):
        out = dit_pipeline_forward(model, x, t, y, stages, microbatches)
    res = {"out": out.detach()}
    if grad:
        (out ** 2).sum().backward()
        res["grads"] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return res


def pipefusion_run(cfg, weights, inputs, chunks, stages=None, chain=None):
    """On `stages` (None: this rank of the spawned world): without `chain`,
    an exact `pipefusion_forward` of (x, t, y) and a chunked one of (x2, t2,
    y) after it, with the cache this rank holds; with `chain` (kwargs of
    `pipefusion_sample_loop` and the respacing), the chain's samples."""
    stages = world_stages() if stages is None else stages
    model = stage_model(cfg, weights, stages)
    arrays = {k: torch.from_numpy(v) for k, v in inputs.items()}
    if chain is not None:
        chain = dict(chain)
        sched = create_diffusion(chain.pop("respacing"), device="cpu").schedule
        return {"out": pipefusion_sample_loop(model, arrays["noise"].shape, sched, arrays["y"],
                                              stages, chunks, noise=arrays["noise"],
                                              step_noise=arrays.get("step_noise"), **chain)}
    kv = init_kv_cache(model, arrays["x"].shape[0], stages=stages)
    out1, kv = pipefusion_forward(model, arrays["x"], arrays["t"], arrays["y"], kv, stages, 1)
    out2, kv = pipefusion_forward(model, arrays["x2"], arrays["t2"], arrays["y"], kv, stages,
                                  chunks)
    return {"exact": out1, "chunked": out2, "kv": kv}
