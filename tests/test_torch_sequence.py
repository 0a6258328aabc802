"""The port's sequence parallelism (fast_dit_torch/parallel/sequence.py)
against the JAX package's (fast_dit_tpu/parallel/sequence.py).

A tiny DiT is made on the JAX side (init plus a 0.05 N(0, 1) perturbation
from a numpy seed, so that the zero-initialised gates do not make the blocks
the identity) and carried into the port through `flax_params_to_state_dict`.
The JAX forward runs under `shard_map` on the conftest's virtual CPU
devices; the port's over `LocalRing(seq)`, n token shards on one device. The
multi-process ring runs in a gloo world of two processes that import torch
and the port only.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.models.layers import DiTBlock as JaxDiTBlock
from fast_dit_tpu.parallel.sequence import create_seq_mesh
from fast_dit_tpu.parallel.sequence import dit_sequence_parallel_forward as jax_sp_forward
from fast_dit_tpu.parallel.sequence import sequence_parallel_stack as jax_sp_stack
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.models import DiT
from fast_dit_torch.ops.ring_attention import ring_attention
from fast_dit_torch.parallel import LocalRing, dit_sequence_parallel_forward, sequence_parallel_stack
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_size=8, patch_size=2, hidden_size=32, depth=4, num_heads=4, num_classes=10)


def _jax_tiny(seed=0):
    model = JaxDiT(**TINY, in_channels=4, attn_backend="einsum")
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, 8, 8)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rs.randn(*p.shape).astype(np.float32), params)
    return model, params


def _port_tiny(params, dtype=torch.float32):
    model = DiT(**TINY, dtype=dtype, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params, 2, 4, 8), strict=True)
    return model.eval()


def _inputs(B=4, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 4, 8, 8).astype(np.float32)
    t = (np.arange(B) * 137 % 1000).astype(np.int32)
    y = (np.arange(B) % 10).astype(np.int32)
    return x, t, y


@pytest.mark.parametrize("seq,data", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_dit_sequence_parallel_forward_matches_jax(seq, data):
    """As test_dit_sequence_parallel_forward_equivalence: the JAX forward on
    a (data, seq) mesh; the port has one device, so its batch holds what the
    data axis splits, and its ring is LocalRing(seq)."""
    jmodel, params = _jax_tiny()
    x, t, y = _inputs()
    want = jax_sp_forward(jmodel, params, x, t, y, mesh=create_seq_mesh(seq, data=data))
    model = _port_tiny(params)
    with torch.no_grad():
        got = dit_sequence_parallel_forward(model, *map(torch.from_numpy, (x, t, y)),
                                            LocalRing(seq))
        dense = model(*map(torch.from_numpy, (x, t, y)))
    assert got.shape == (4, 8, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=5e-5, atol=5e-5)


def test_sequence_parallel_stack_gradients_match_jax():
    """As test_sequence_parallel_stack_gradients: d sum(out^2) / d block
    params through the token-sharded stack (ring of 4), the JAX gradient
    tree mapped into the port's names through the same converter."""
    jmodel, params = _jax_tiny()
    rs = np.random.RandomState(5)
    tokens = rs.randn(2, 16, 32).astype(np.float32)
    c = rs.randn(2, 32).astype(np.float32)
    block = JaxDiTBlock(32, 4, attn_backend="ring:seq")
    mesh = create_seq_mesh(4)

    def loss(sp):
        out = jax_sp_stack(lambda lp, xs, cs: block.apply({"params": lp}, xs, cs),
                           sp, tokens, c, mesh=mesh)
        return jnp.sum(out ** 2)

    g_stack = jax.grad(loss)(params["params"]["blocks"]["block"])
    g_tree = jax.tree.map(np.asarray, params)
    g_tree["params"]["blocks"]["block"] = jax.tree.map(np.asarray, g_stack)
    want = flax_params_to_state_dict(g_tree, 2, 4, 8)

    model = _port_tiny(params)
    out = sequence_parallel_stack(model.blocks, torch.from_numpy(tokens), torch.from_numpy(c),
                                  LocalRing(4))
    (out ** 2).sum().backward()
    names = [n for n, _ in model.blocks.named_parameters()]
    assert len(names) == TINY["depth"] * len(jax.tree.leaves(g_stack))
    for name, p in model.blocks.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[f"blocks.{name}"].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_bf16_sequence_parallel_forward_matches_unsharded():
    """bf16 takes the clamped hops (their plain versions on the CPU); the
    unsharded bf16 model takes exact attention. Logits stay far below 50."""
    _, params = _jax_tiny(seed=2)
    model = _port_tiny(params, dtype=torch.bfloat16)
    x, t, y = map(torch.from_numpy, _inputs(seed=3))
    with torch.no_grad():
        got = dit_sequence_parallel_forward(model, x, t, y, LocalRing(4))
        want = model(x, t, y)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def test_sequence_parallel_forward_needs_divisible_tokens():
    _, params = _jax_tiny()
    model = _port_tiny(params)
    x, t, y = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="do not split"):
        dit_sequence_parallel_forward(model, x, t, y, LocalRing(3))


def test_remat_keeps_the_sequence_parallel_gradients():
    """With remat on, the backward recomputes each block around the ring;
    the output and every parameter gradient are those of the run without."""
    _, params = _jax_tiny(seed=8)
    x, t, y = map(torch.from_numpy, _inputs(B=2, seed=9))
    runs = []
    for remat in (False, True):
        model = _port_tiny(params)
        model.remat = remat
        out = dit_sequence_parallel_forward(model, x, t, y, LocalRing(4))
        (out ** 2).sum().backward()
        runs.append((out.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (out0, g0), (out1, g1) = runs
    assert torch.equal(out0, out1)
    for n, g in g0.items():
        torch.testing.assert_close(g1[n], g, rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("policy", ["nothing", "attn", "attn_mlp"])
def test_remat_policies_keep_the_sequence_parallel_gradients(policy):
    """Each remat policy around the ring (its regions recompute ring
    attention in the backward): the output and every gradient equal the run
    without remat, bit for bit."""
    _, params = _jax_tiny(seed=8)
    x, t, y = map(torch.from_numpy, _inputs(B=2, seed=9))
    runs = []
    for remat in (False, True):
        model = _port_tiny(params)
        model.remat, model.remat_policy = remat, policy
        out = dit_sequence_parallel_forward(model, x, t, y, LocalRing(4))
        (out ** 2).sum().backward()
        runs.append((out.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (out0, g0), (out1, g1) = runs
    assert torch.equal(out0, out1)
    for n, g in g0.items():
        assert torch.equal(g1[n], g), n


# One rank of a gloo world of two: the ring attention and the tiny DiT's
# sequence-parallel forward over ProcessGroupRing, with the gradients each
# rank holds, saved for the parent to sum and compare. Imports torch and the
# port only (never this file or tests/conftest.py, which import JAX).
_WORKER = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                        rank=rank, timeout=datetime.timedelta(seconds=60))
from fast_dit_torch.ops.ring_attention import ring_attention
from fast_dit_torch.parallel import ProcessGroupRing, create_seq_groups
from fast_dit_torch.parallel import dit_sequence_parallel_forward
seq_group, data_group = create_seq_groups(2)
ring = ProcessGroupRing(seq_group)
assert (ring.size, ring.rank) == (2, rank)
res = {}
data = np.load(out + "/inputs.npz")
for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
    q, k, v = (torch.from_numpy(data[n]).to(dtype).requires_grad_() for n in "qkv")
    o = ring.unshard(ring_attention(ring.shard(q), ring.shard(k), ring.shard(v), ring))
    ((o.float() - torch.from_numpy(data["tgt"])) ** 2).sum().backward()
    res[name + "_out"] = o.detach().float().numpy()
    for n, tns in zip("qkv", (q, k, v)):
        res[f"{name}_d{n}"] = tns.grad.float().numpy()
model = torch.load(out + "/model.pt", weights_only=False)
x, t, y = (torch.from_numpy(data[n]) for n in ("x", "t", "y"))
sp = dit_sequence_parallel_forward(model, x, t, y, ring)
(sp ** 2).sum().backward()
res["dit_out"] = sp.detach().numpy()
for n, p in model.named_parameters():
    res["grad_" + n] = p.grad.numpy()
np.savez(out + f"/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_group_ring_matches_local_ring(tmp_path):
    """Two gloo ranks against LocalRing(2) in this process: the gathered
    outputs are equal on both ranks, and the per-rank gradients of the
    inputs and of every DiT parameter sum to the local ring's."""
    rs = np.random.RandomState(6)
    q, k, v, tgt = (rs.randn(2, 16, 2, 8).astype(np.float32) for _ in range(4))
    _, params = _jax_tiny(seed=4)
    model = _port_tiny(params)
    x, t, y = _inputs(B=2, seed=7)
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, tgt=tgt, x=x, t=t, y=y)
    torch.save(model, tmp_path / "model.pt")

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port), str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    ring = LocalRing(2)
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
        o = ring.unshard(ring_attention(*(ring.shard(tns) for tns in ts), ring))
        ((o.float() - torch.from_numpy(tgt)) ** 2).sum().backward()
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        for r in ranks:
            np.testing.assert_allclose(r[name + "_out"], o.detach().float().numpy(),
                                       rtol=tol, atol=tol)
        for n, tns in zip("qkv", ts):
            summed = ranks[0][f"{name}_d{n}"] + ranks[1][f"{name}_d{n}"]
            np.testing.assert_allclose(summed, tns.grad.float().numpy(), rtol=tol, atol=tol)

    xt, tt, yt = map(torch.from_numpy, (x, t, y))
    sp = dit_sequence_parallel_forward(model, xt, tt, yt, ring)
    (sp ** 2).sum().backward()
    for r in ranks:
        np.testing.assert_allclose(r["dit_out"], sp.detach().numpy(), rtol=1e-5, atol=1e-5)
    for n, p in model.named_parameters():
        summed = ranks[0]["grad_" + n] + ranks[1]["grad_" + n]
        np.testing.assert_allclose(summed, p.grad.numpy(), rtol=1e-4, atol=1e-5, err_msg=n)
