"""The port's mixture-of-experts DiT (fast_dit_torch/models/moe.py, the MoE
option of the blocks, the converter's MoE names, the train step's aux
losses) against the JAX package (`fast_dit_tpu/models/moe.py`,
`train/train_lib.py:159-212`).

Weights are made on the JAX side (init + a 0.02 N(0, 1) perturbation) and
carried into the port through `flax_params_to_state_dict`, whose MoE names
are the port's own (`blocks.{i}.mlp.router.weight`, `.wi`, `.bi`, `.wo`,
`.bo`). Routing is compared exactly (the chosen experts and the kept
mask), values in fp32 within 1e-5 of max (bf16: 2e-2), the aux values
within 1e-6 relative, and the train steps of JAX's own `make_train_step`
with its draws injected within the limits of tests/test_torch_train.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.models import DiT_models as jax_models
from fast_dit_tpu.models.moe import MoeMlp as JaxMoeMlp
from fast_dit_tpu.models.moe import _top_k_one_hot
from fast_dit_tpu.models.moe import expert_capacity as jax_expert_capacity
from fast_dit_tpu.ops.fused_update import FactoredNu as JaxFactoredNu
from fast_dit_tpu.ops.fused_update import fused_adamw_ema_init as jax_fused_init
from fast_dit_tpu.train.train_lib import TrainState as JaxTrainState
from fast_dit_tpu.train.train_lib import make_train_step as jax_make_train_step
from fast_dit_torch import sample as sample_cli
from fast_dit_torch.ckpt import flax_params_to_state_dict, jax_leaves
from fast_dit_torch.diffusion import create_diffusion
from fast_dit_torch.models import DiT, DiT_models, MoeMlp, expert_capacity
from fast_dit_torch.models.layers import Mlp
from fast_dit_torch.models.moe import top_k_gates
from fast_dit_torch.ops.fused_update import FactoredNu, fused_adamw_ema_init
from fast_dit_torch.train import cli as train_cli
from fast_dit_torch.train import create_train_state, make_train_step
from test_torch_train import _batch, _jax_draws, _rtol
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # outputs, relative to max |out|
AUX_RTOL = 1e-6
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
LR, DECAY, STEPS, B = 1e-4, 0.9999, 2, 4
# the train tests' narrow DiT (16 tokens, 2 heads of 64) with 4 experts, top-2
CFG = dict(input_size=8, patch_size=2, hidden_size=128, depth=2, num_heads=2, num_classes=10,
           moe_experts=4, moe_top_k=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32),
                        tree)


def _moe_pair(D=32, E=4, H=64, k=2, factor=1.25, dtype=torch.float32, seed=0):
    """A JAX MoeMlp and the port's with the same (perturbed) weights."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JaxMoeMlp(E, H, D, top_k=k, capacity_factor=factor, dtype=jdt)
    params = _perturb(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, D))), seed)
    p = params["params"]
    tm = MoeMlp(D, E, H, top_k=k, capacity_factor=factor, dtype=dtype)
    with torch.no_grad():
        tm.router.weight.copy_(torch.from_numpy(p["router"]["kernel"].T.copy()))
        for n in ("wi", "bi", "wo", "bo"):
            getattr(tm, n).copy_(torch.from_numpy(p[n]))
    return jm, params, tm


def _jax_keep(params, x, k, E, C):
    """JAX's kept (choice, token) slots, choice-major: its `_top_k_one_hot`
    and its capacity lines (`moe.py:115-118`)."""
    gates = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ params["params"]["router"]["kernel"], -1)
    sel, _ = _top_k_one_hot(gates, k)
    B, S = x.shape[:2]
    sel_f = sel.transpose(0, 2, 1, 3).reshape(B, k * S, E)
    pos = jnp.cumsum(sel_f, axis=1) - sel_f
    return np.asarray(jnp.sum(sel_f * (pos < C), axis=-1)) > 0


def test_single_expert_equals_the_dense_mlp():
    """E=1, k=1, ample capacity: the gate is 1 and nothing is dropped."""
    torch.manual_seed(0)
    mlp = Mlp(32, 64)
    moe = MoeMlp(32, 1, 64, top_k=1, capacity_factor=2.0)
    moe.init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():
        moe.wi.copy_(mlp.fc1.weight.T[None])
        moe.bi.copy_(torch.randn(1, 64))
        mlp.fc1.bias.copy_(moe.bi[0])
        moe.wo.copy_(mlp.fc2.weight.T[None])
        moe.bo.copy_(mlp.fc2.bias[None])
        x = torch.randn(2, 16, 32)
        y, aux = moe(x)
        want = mlp(x)
    assert aux[2].item() == 0.0  # nothing dropped
    assert (y - want).abs().max().item() <= RTOL[torch.float32] * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["capacity-1.25", "overflow-0.5"])
def test_moe_mlp_matches_jax(dtype, factor):
    """Outputs, the kept mask (exactly; at factor 0.5 about half the slots
    overflow) and the sown aux values."""
    D, E, k, S = 32, 4, 2, 24
    jm, params, tm = _moe_pair(factor=factor, dtype=dtype)
    x = np.random.RandomState(1).randn(3, S, D).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want, sown = jm.apply(params, jnp.asarray(x).astype(jdt), mutable=["losses"])
    want = np.asarray(want, np.float32)
    tx = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        got, aux = tm(tx)
        routing = tm.route(tx)
    assert got.dtype == dtype and got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= RTOL[dtype] * np.abs(want).max()
    C = expert_capacity(S, E, k, factor)
    assert C == jax_expert_capacity(S, E, k, factor) == routing.capacity
    jkeep = _jax_keep(params, np.asarray(jnp.asarray(x).astype(jdt), np.float32), k, E, C)
    assert np.array_equal(routing.keep.numpy(), jkeep)
    if factor < 1:
        assert 0.2 < 1 - jkeep.mean() < 0.8
    losses = sown["losses"]
    for i, name in enumerate(("load_balance", "router_z", "dropped_frac")):
        w = float(losses[name])
        assert abs(aux[i].item() - w) <= AUX_RTOL * max(abs(w), 1.0), name
    assert aux[2].item() == pytest.approx(1 - jkeep.mean(), abs=1e-7)


def test_first_choices_claim_capacity_first_and_dropped_slots_add_nothing():
    D, E, H = 16, 2, 32
    tm = MoeMlp(D, E, H, top_k=2, capacity_factor=0.25)  # C = ceil(2*8*0.25/2) = 2
    tm.init_weights(torch.Generator().manual_seed(3))
    x = torch.randn(1, 8, D, generator=torch.Generator().manual_seed(4))
    r = tm.route(x)
    assert r.capacity == 2
    keep = r.keep.reshape(2, 8)  # (choice, token)
    # per expert, the kept slots are its first C slots in choice-major order
    for e in range(E):
        slots = (r.choice[0] == e).nonzero().flatten()
        assert r.keep[0, slots[:2]].all() and not r.keep[0, slots[2:]].any()
    with torch.no_grad():
        y, _ = tm(x)
    dropped_both = ~keep.any(dim=0)
    assert torch.isfinite(y).all()
    assert (y[0, dropped_both] == 0).all() and dropped_both.any()


def test_top_k_never_reselects_on_underflow():
    gates = torch.tensor([[[0.0, 1.0, 0.0, 0.0]]])  # every other gate underflowed
    idx, topg = top_k_gates(gates, 2)
    assert idx.tolist() == [[[1, 0]]]  # a second, distinct expert: the first of the ties
    sel, _ = _top_k_one_hot(jnp.asarray(gates.numpy()), 2)
    assert np.asarray(jnp.argmax(sel[0, 0], -1)).tolist() == [1, 0]


def test_combine_weights_sum_to_one():
    """Kept gates are renormalised: E=2, k=2 keeps both, so each token's
    output is sum_e gate_e * expert_e(x) (JAX's tests/test_moe.py:153)."""
    tm = MoeMlp(16, 2, 32, top_k=2, capacity_factor=2.0)
    tm.init_weights(torch.Generator().manual_seed(5))
    with torch.no_grad():
        tm.bi.normal_(generator=torch.Generator().manual_seed(6))
        x = torch.randn(1, 8, 16, generator=torch.Generator().manual_seed(7))
        r = tm.route(x)
        assert torch.allclose(r.topg.sum(-1), torch.ones(1, 8), atol=1e-7)
        gates = torch.softmax(x @ tm.router.weight.T, -1)
        dense = [torch.nn.functional.gelu(x @ tm.wi[e] + tm.bi[e], approximate="tanh")
                 @ tm.wo[e] + tm.bo[e] for e in range(2)]
        want = gates[..., :1] * dense[0] + gates[..., 1:] * dense[1]
        got, _ = tm(x)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_registry_configs_equal_jax():
    for name in ("DiT-MoE-S/2-8E2A", "DiT-MoE-B/2-8E2A", "DiT-MoE-XL/2-8E2A"):
        j, p = jax_models[name].keywords, DiT_models[name].keywords
        assert j == p, name
        model = DiT_models[name](input_size=8, depth=1, device="cpu")
        assert model.moe_experts == 8 and model.blocks[0].mlp.top_k == 2


def _jax_moe_params(seed=0, **kw):
    model = JaxDiT(**{**CFG, **kw})
    n = CFG["input_size"]
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, n, n)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    return model, _perturb(params, seed)


def _port_moe(params, **kw):
    model = DiT(**{**CFG, **kw}, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params, 2, 4, CFG["input_size"]),
                          strict=True)
    return model


def test_converter_names_and_jax_leaves_of_a_moe_tree():
    _, params = _jax_moe_params()
    sd = flax_params_to_state_dict(params, 2, 4, 8)
    block = params["params"]["blocks"]["block"]["mlp"]
    for i in range(CFG["depth"]):
        assert np.array_equal(sd[f"blocks.{i}.mlp.router.weight"].numpy(),
                              block["router"]["kernel"][i].T)
        for n in ("wi", "bi", "wo", "bo"):
            assert np.array_equal(sd[f"blocks.{i}.mlp.{n}"].numpy(), block[n][i])
    assert not any(".fc1." in k or ".fc2." in k for k in sd)
    # the leaves: JAX's paths and stacked shapes, and the factored nu's rows
    # and cols of JAX's fused state
    model = _port_moe(params)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path[1:]): np.shape(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    leaves = jax_leaves(model)
    assert [leaf.path for leaf in leaves] == list(flat)
    assert {leaf.path: leaf.shape for leaf in leaves} == flat
    assert dict((leaf.path, leaf.shape) for leaf in leaves)["blocks/block/mlp/wi"] == (2, 4, 128,
                                                                                      512)
    is_fnu = lambda n: isinstance(n, JaxFactoredNu)
    jnu = {"/".join(str(getattr(k, "key", k)) for k in path[1:]): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(
               jax_fused_init(params, factored=True).nu, is_leaf=is_fnu)[0]}
    state = fused_adamw_ema_init(list(model.parameters()), factored=True, leaves=leaves)
    got = {v.leaf.path: v for v in state.nu if isinstance(v, FactoredNu)}
    assert set(got) == {k for k, v in jnu.items() if is_fnu(v)} and "blocks/block/mlp/wi" in got
    for path, v in got.items():
        assert v.row.shape == jnu[path].row.shape and v.col.shape == jnu[path].col.shape, path


def test_moe_dit_forward_matches_jax():
    jmodel, params = _jax_moe_params(attn_backend="pallas")
    model = _port_moe(params).eval()
    rs = np.random.RandomState(1)
    x = rs.randn(4, 4, 8, 8).astype(np.float32)
    t = rs.randint(0, 1000, size=4).astype(np.int32)
    y = np.array([1, 7, 10, 10], np.int32)
    want = np.asarray(jax.jit(lambda p, x, t, y: jmodel.apply(
        p, x, t, y, 4.0, method=jmodel.forward_with_cfg))(params, x, t, y))
    want_sown = jax.jit(lambda p, x, t, y: jmodel.apply(p, x, t, y, mutable=["losses"]))(
        params, x, t, y)[1]["losses"]
    tx, tt, ty = torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y).long()
    with torch.no_grad():
        got = model.forward_with_cfg(tx, tt, ty, 4.0).numpy()
        _, aux = model(tx, tt, ty, want_aux=True)
    assert np.abs(got - want).max() <= RTOL[torch.float32] * np.abs(want).max()
    sown = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(want_sown)[0]}
    for name, v in aux.items():
        (w,) = [a for k, a in sown.items() if name in k]
        assert w.shape == v.shape == (CFG["depth"],)
        assert np.abs(v.numpy() - w).max() <= AUX_RTOL * max(np.abs(w).max(), 1.0), name
    with pytest.raises(ValueError, match="sequence parallelism is exact-only"):
        from fast_dit_torch.parallel import LocalRing
        model(tx, tt, ty, ring=LocalRing(2))


def _jax_moe_state(params, route):
    step0 = jnp.zeros((), jnp.int32)
    if route == "fused":
        p16 = jax.tree.map(lambda p: jnp.asarray(p).astype(jnp.bfloat16), params)
        opt = jax_fused_init(p16, mu_dtype=jnp.bfloat16)
        return JaxTrainState(step=step0, params=p16, ema=jax.tree.map(jnp.copy, opt.master),
                             opt_state=opt), None
    params = jax.tree.map(jnp.asarray, params)
    tx = optax.adamw(LR, weight_decay=0.0)
    return JaxTrainState(step=step0, params=params, ema=jax.tree.map(jnp.copy, params),
                         opt_state=tx.init(params)), tx


def _sd(tree):
    sd = flax_params_to_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), tree), 2,
                                   4, 8)
    return {k: v.numpy() for k, v in sd.items() if k != "pos_embed"}


@pytest.mark.parametrize("route,grad_accum,remat,policy", [
    ("default", 1, False, "nothing"), ("default", 2, True, "nothing"),
    ("default", 1, True, "attn"), ("default", 1, True, "attn_mlp"),
    ("fused", 1, True, "nothing"), ("fused", 2, True, "attn_mlp")],
    ids=["default", "grad-accum-2-remat", "remat-attn", "remat-attn_mlp", "fused-remat",
         "fused-grad-accum-2-attn_mlp"])
def test_moe_train_steps_match_jax(route, grad_accum, remat, policy):
    """Two steps of JAX's `make_train_step` (aux weights 1e-2 and 1e-3) and
    the port's: the losses and the MoE metrics; the first step's gradients,
    which JAX's first moment holds as (1 - b1) g (GRAD_RTOL of each leaf's
    largest; the fused route's bf16 moments to one bf16 ulp, 2^-7, as in
    tests/test_torch_train.py); nonzero router gradients in every block;
    then the parameters (2 lr per step) and the EMA."""
    fused = route == "fused"
    jmodel, params = _jax_moe_params(class_dropout_prob=0.0, remat=remat, remat_policy=policy)
    jstate, tx = _jax_moe_state(params, route)
    jstep = jax.jit(jax_make_train_step(jmodel, jax_create_diffusion("").schedule, tx,
                                        ema_decay=DECAY, grad_accum=grad_accum, lr=LR,
                                        log_grad_norm=True))
    model = _port_moe(params, class_dropout_prob=0.0, remat=remat, remat_policy=policy)
    state = create_train_state(model, lr=None if fused else LR, fused_optimizer=fused)
    step = make_train_step(model, create_diffusion("", device="cpu").schedule, ema_decay=DECAY,
                           grad_accum=grad_accum, lr=LR, log_grad_norm=True)
    x, y = _batch()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y.astype(np.int64))}
    rng = jax.random.PRNGKey(0)
    names = [n for n, _ in model.named_parameters()]
    for s in range(STEPS):
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, rng)
        m = step(state, batch, draws=_jax_draws(rng, s, grad_accum))
        for k in ("loss", "mse", "vb", "moe_load_balance", "moe_router_z", "grad_norm"):
            rtol = 2 ** -8 if k == "grad_norm" and fused else LOSS_RTOL
            assert abs(m[k].item() - float(jm[k])) <= rtol * abs(float(jm[k])) + 1e-7, k
        assert abs(m["moe_dropped_frac"].item() - float(jm["moe_dropped_frac"])) <= 1e-7
        if s == 0:
            mu = _sd(jstate.opt_state.mu if fused else jstate.opt_state[0].mu)
            for n, p in model.named_parameters():
                got, want = 0.1 * p.grad.float().numpy(), mu[n]
                rtol = 2 ** -7 if fused else _rtol(n)
                assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30), n
                if n.endswith("mlp.router.weight"):
                    assert np.abs(p.grad.float().numpy()).max() > 0, n
    bound = 2 * LR * STEPS
    want_p = _sd(jstate.params)
    for n, p in model.named_parameters():
        want = want_p[n]
        ulp = 0 if not fused else 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert (np.abs(p.detach().float().numpy() - want) <= np.maximum(bound, ulp)).all(), n
    want_e = _sd(jstate.ema)
    for n in names:
        assert np.abs(state.ema[n].numpy() - want_e[n]).max() <= (1 - DECAY) * bound + 1e-6, n


def test_aux_losses_reach_the_router_and_are_counted_once_under_remat():
    """The router's gradient under each remat policy equals no remat's bit
    for bit: the aux values are outputs of the checkpointed region, so the
    recompute neither counts them twice nor cuts them off."""
    grads = []
    for remat, policy in ((False, "nothing"), (True, "nothing"), (True, "attn"),
                          (True, "attn_mlp")):
        model = DiT(**CFG, remat=remat, remat_policy=policy, device="cpu", seed=3)
        x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
        out, aux = model(x, torch.tensor([1, 500]), torch.tensor([2, 3]), train=True,
                         force_drop_ids=torch.tensor([0, 1]), want_aux=True)
        (out.square().mean() + aux["load_balance"].mean() + aux["router_z"].mean()).backward()
        grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
        assert model.blocks[0].mlp.router.weight.grad.abs().max() > 0
    assert all(torch.equal(grads[0], g) for g in grads[1:])


def test_sample_cli_with_a_moe_model_matches_the_jax_chain(tmp_path, monkeypatch):
    """`python -m fast_dit_torch.sample --model DiT-MoE-S/2-8E2A` (DDIM, 2
    steps, no CFG) on weights carried from JAX: the saved latents equal the
    JAX MoE model's DDIM chain, as the JAX CLI runs it (`sample.py:79-88`,
    `:118`, `:176-180`), from the same x_T, within 1e-4 of max."""
    jmodel = jax_models["DiT-MoE-S/2-8E2A"](input_size=32, attn_backend="pallas")
    params = _perturb(jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 32, 32)),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)), 0)
    torch.save(flax_params_to_state_dict(params, 2, 4, 32), tmp_path / "w.pt")
    monkeypatch.chdir(tmp_path)
    args = sample_cli.parse_args(["--device", "cpu", "--ckpt", str(tmp_path / "w.pt"),
                                  "--model", "DiT-MoE-S/2-8E2A", "--sampler", "ddim",
                                  "--num-sampling-steps", "2", "--cfg-scale", "1.0"])
    sample_cli.main(args)
    got = np.load(tmp_path / "sample.npy")
    z, y, _ = sample_cli.sampling_inputs(
        args, sample_cli.build_model(args, torch.device("cpu"), args.seed))
    jy = y.numpy().astype(np.int32)
    run = jax.jit(lambda p, n: jax_create_diffusion("2").ddim_sample_loop(
        lambda x, t: jmodel.apply(p, x, t, jy), n.shape, noise=n, clip_denoised=False))
    want = np.asarray(run(params, z.numpy()))
    assert got.shape == want.shape == (8, 4, 32, 32)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_trainer_cli_trains_a_moe_model_and_logs_its_aux_losses(tmp_path):
    args = train_cli.parse_args(["--device", "cpu", "--synthetic-data",
                                 "--model", "DiT-MoE-S/2-8E2A", "--max-steps", "2",
                                 "--global-batch-size", "2", "--log-every", "1",
                                 "--results-dir", str(tmp_path), "--export-pt"])
    train_cli.main(args)
    (exp,) = tmp_path.iterdir()
    log = (exp / "log.txt").read_text()
    assert log.count("Train Loss") == 2
    lines = re.findall(r"MoE Load Balance: ([\d.]+), Router Z: ([\d.]+), "
                       r"Dropped Frac: ([\d.]+)", log)
    assert len(lines) == 2 and all(float(lb) > 0 and float(z) > 0 for lb, z, _ in lines)
    ckpt = torch.load(exp / "checkpoints" / "0000002.pt", weights_only=False)
    assert ckpt["ema"]["blocks.11.mlp.wi"].shape == (8, 384, 1536)
    model = DiT_models["DiT-MoE-S/2-8E2A"](input_size=32, device="cpu")
    model.load_state_dict(torch.load(exp / "checkpoints" / "0000002-ema.pt"), strict=True)
