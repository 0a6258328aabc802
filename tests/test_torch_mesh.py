"""The port's meshes and sharding rules (`fast_dit_torch/parallel/mesh.py`)
against JAX's (`fast_dit_tpu/parallel/mesh.py`).

- `dit_param_spec` gives JAX's PartitionSpec on every leaf of a small dense
  DiT and a small MoE DiT, with the port's leaf paths and stacked shapes
  (`ckpt.convert.jax_leaves`) equal to JAX's param tree's, for tp, fsdp and
  ep off or 2 and each legal combination.
- The mesh constructors refuse the sizes JAX's refuse.
- `shard_params` leaves on each rank of a mesh exactly the slice of every
  parameter that JAX puts on that device: each JAX shard
  (`addressable_shards` of the device_put tree, placed by
  `param_shardings`), mapped to the port's layout, equals the port
  tensor's local part, bit for bit; a spec on the layer axis gives whole
  blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.parallel import create_expert_mesh as jax_expert_mesh
from fast_dit_tpu.parallel import create_mesh as jax_mesh
from fast_dit_tpu.parallel import dit_param_spec as jax_spec
from fast_dit_tpu.parallel import param_shardings as jax_param_shardings
from fast_dit_torch.ckpt import flax_params_to_state_dict, jax_leaves
from fast_dit_torch.models import DiT
from fast_dit_torch.parallel.mesh import (Mesh, create_expert_mesh, create_mesh,
                                          dit_param_spec, shard_params)

from test_torch_world import one_torch_thread  # noqa: F401 (an autouse fixture)

DENSE = dict(input_size=8, patch_size=2, hidden_size=32, depth=2, num_heads=4, num_classes=10)
MOE = dict(DENSE, moe_experts=4, moe_top_k=2)
# depth 4 at hd 4: FSDP picks the layer axis of the qkv bias (4, 3, 4, 4)
DEEP = dict(input_size=8, patch_size=2, hidden_size=16, depth=4, num_heads=4, num_classes=10)

# (tp, fsdp, inner mesh axis, inner size, data size): JAX's legal meshes
MODES = [(False, False, "model", 1, 2), (False, True, "model", 1, 2),
         (True, False, "model", 2, 1), (True, False, "model", 2, 2),
         (True, True, "model", 2, 2), (False, False, "expert", 2, 1),
         (False, True, "expert", 2, 2), (False, False, "model", 1, 4),
         (False, True, "model", 1, 4)]


def _cases(modes):
    """(cfg, mode) pairs; an expert mesh serves a MoE model only
    (`train.py:75-79`)."""
    out = []
    for name, cfg in (("dense", DENSE), ("moe", MOE), ("deep", DEEP)):
        for mode in modes:
            if mode[2] != "expert" or cfg.get("moe_experts"):
                out.append(pytest.param(cfg, *mode, id=f"{name}-{'-'.join(map(str, mode))}"))
    return out


def _jax_tree(cfg):
    model = JaxDiT(**cfg, attn_backend="xla")
    n = cfg["input_size"]
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, n, n)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(1)
    return jax.tree.map(lambda p: jnp.asarray(np.asarray(p) + rs.randn(*p.shape)
                                              .astype(np.float32)), params)


def _jax_mesh(inner, m, data):
    devices = jax.devices()[:m * data]
    return (jax_expert_mesh(m, data=data, devices=devices) if inner == "expert"
            else jax_mesh(data=data, model=m, devices=devices))


def _port_mesh(inner, m, data, rank=0):
    return Mesh(data, m, inner, rank)


def _leaf_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("cfg,tp,fsdp,inner,m,data", _cases(MODES))
def test_param_spec_equals_jax_on_every_leaf(cfg, tp, fsdp, inner, m, data):
    tree = _jax_tree(cfg)
    jmesh = _jax_mesh(inner, m, data)
    jsh = _leaf_paths(jax_param_shardings(tree, jmesh, tp=tp, fsdp=fsdp))
    model = DiT(**cfg, device="cpu")
    leaves = jax_leaves(model)
    assert {f"params/{leaf.path}" for leaf in leaves} == set(jsh)
    mesh = _port_mesh(inner, m, data)
    jtree = _leaf_paths(tree)
    for leaf in leaves:
        path = f"params/{leaf.path}"
        assert tuple(jtree[path].shape) == leaf.shape, path
        want = tuple(jsh[path].spec) + (None,) * (len(leaf.shape) - len(jsh[path].spec))
        got = dit_param_spec(leaf.path, leaf.shape, tp=tp, fsdp=fsdp, mesh=mesh)
        assert got == want, path
        # JAX's rule itself, on the full path, agrees with its sharding tree
        assert tuple(jax_spec(path, leaf.shape, tp=tp, fsdp=fsdp, mesh=jmesh)) == \
            tuple(jsh[path].spec)


def test_the_layer_axis_spec_arises():
    """The DEEP config reaches the layer-axis case that shard_params maps
    to whole blocks."""
    model = DiT(**DEEP, device="cpu")
    mesh = _port_mesh("model", 1, 2)
    specs = {leaf.path: dit_param_spec(leaf.path, leaf.shape, tp=False, fsdp=True, mesh=mesh)
             for leaf in jax_leaves(model)}
    assert specs["blocks/block/attn/qkv/bias"] == ("data", None, None, None)


def test_mesh_checks_raise_as_jax_does():
    # JAX: "N devices not divisible by model=M" (assert) and "mesh data=.. x
    # model=.. uses .. of N devices" (ValueError)
    with pytest.raises(AssertionError):
        jax_mesh(model=3)
    with pytest.raises(AssertionError, match="not divisible by model=3"):
        create_mesh(model=3, world=8)
    with pytest.raises(AssertionError, match="not divisible by expert=3"):
        create_expert_mesh(3, world=8)
    with pytest.raises(ValueError):
        jax_mesh(data=2, model=2)
    with pytest.raises(ValueError, match="mesh data=2 x model=2 uses 4 of 8"):
        create_mesh(data=2, model=2, world=8)
    with pytest.raises(ValueError):
        jax_expert_mesh(2, data=2)
    with pytest.raises(ValueError, match="mesh data=2 x expert=2 uses 4 of 8"):
        create_expert_mesh(2, data=2, world=8)
    assert create_mesh(model=2, world=8).shape == {"data": 4, "model": 2}
    assert create_expert_mesh(4, world=8).shape == {"data": 2, "expert": 4}


@pytest.mark.parametrize("cfg,tp,fsdp,inner,m,data", _cases([
    (False, True, "model", 1, 2), (True, False, "model", 2, 2), (True, True, "model", 2, 2),
    (False, True, "expert", 2, 2), (False, True, "model", 1, 4)]))
def test_shard_params_puts_each_slice_where_jax_does(cfg, tp, fsdp, inner, m, data):
    tree = _jax_tree(cfg)
    jmesh = _jax_mesh(inner, m, data)
    placed = _leaf_paths(jax.device_put(tree, jax_param_shardings(tree, jmesh, tp=tp,
                                                                  fsdp=fsdp)))
    full = flax_params_to_state_dict(jax.tree.map(np.asarray, tree), cfg["patch_size"], 4,
                                     cfg["input_size"])
    # the device at mesh position (data i, inner j) is rank i * m + j
    where = {d: r for r, d in enumerate(np.asarray(jmesh.devices).reshape(-1))}
    for rank in range(m * data):
        model = DiT(**cfg, device="cpu")
        model.load_state_dict(full, strict=True)
        sharding = shard_params(model, _port_mesh(inner, m, data, rank), tp=tp, fsdp=fsdp)
        params = list(model.parameters())
        for leaf in sharding.leaves:
            arr = placed[f"params/{leaf.path}"]
            (shard,) = [s for s in arr.addressable_shards if where[s.device] == rank]
            data_np = np.asarray(shard.data)
            for k, i in enumerate(leaf.members):
                s = sharding.shards[i]
                local = params[i].detach()
                if leaf.stacked:
                    start = shard.index[0].start or 0
                    if not start <= k < start + data_np.shape[0]:
                        assert local.numel() == 0, (leaf.path, rank, k)  # another's block
                        continue
                    one = data_np[k - start]
                else:
                    one = data_np
                want = s.from_jax(torch.from_numpy(np.ascontiguousarray(one)))
                assert torch.equal(local, want), (leaf.path, rank, k)
        # the attention and MLP modules know their share
        heads = cfg["num_heads"] // (m if tp else 1)
        assert all(b.attn.num_heads == heads for b in model.blocks)
        if cfg.get("moe_experts") and (tp or inner == "expert"):
            assert [b.mlp.expert_offset for b in model.blocks] == \
                [(rank % m) * cfg["moe_experts"] // m] * cfg["depth"]
