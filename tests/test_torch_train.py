"""The port's training slice (fast_dit_torch/train, models, diffusion losses)
against the JAX package, and its CLI in process.

Weights are made once on the JAX side (init + a 0.02 N(0, 1) perturbation
from a numpy seed) and carried into the port through
`flax_params_to_state_dict`; the batch is numpy. The model is DiT-shaped but
narrow (width 128, 2 heads of 64, depth 2, 8x8 latents: 16 tokens), so the
JAX Pallas backward's lane rule (3D % 128 == 0) holds and it runs.

- One step's loss and gradients against `jax.value_and_grad` of the JAX
  loss, with the JAX model on attn_backend="hybrid" and remat=True, so that
  its fused Pallas backward `_bwd_kernel` runs (interpreted), and label
  drops forced the same way on both sides.
- Two steps of the real JAX `make_train_step` against the port's, for the
  default, `--mixed-precision` and `--fused-optimizer` routes and for
  grad_accum=2, at class_dropout_prob=0 (flax derives the label-drop key
  inside `make_rng`, which torch cannot reproduce), with t and noise drawn
  from the JAX step's own key splits (`train_lib.py:216-231`) and injected.

Tolerances: gradients are compared tightly. Adam moves a parameter by about
+-lr whatever the size of its gradient, so where a gradient sits near 0 the
two sides may step apart by up to 2 lr a step: parameters and masters are
held to 2 lr per step (bf16 parameters also to one bf16 ulp, where a master
rounds apart), the EMA to (1 - decay) of that.
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
from fast_dit_tpu.diffusion.gaussian import training_losses as jax_training_losses
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.models.layers import LabelEmbedder as JaxLabelEmbedder
from fast_dit_tpu.ops.fused_update import FactoredNu as JaxFactoredNu
from fast_dit_tpu.ops.fused_update import fused_adamw_ema_init as jax_fused_init
from fast_dit_tpu.train.mixed_precision import masterize as jax_masterize
from fast_dit_tpu.train.train_lib import TrainState as JaxTrainState
from fast_dit_tpu.train.train_lib import make_train_step as jax_make_train_step
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.diffusion import create_diffusion
from fast_dit_torch.diffusion.gaussian import training_losses
from fast_dit_torch.models import DiT
from fast_dit_torch.ops import _build
from fast_dit_torch.ops.fused_update import FactoredNu
from fast_dit_torch.train import create_train_state, make_train_step
from fast_dit_torch.train import cli
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

CFG = dict(input_size=8, patch_size=2, hidden_size=128, depth=2, num_heads=2, num_classes=10)
LR, DECAY, STEPS, B = 1e-4, 0.9999, 2, 4
LOSS_RTOL = 1e-5   # fp32 losses, sums in other orders
GRAD_RTOL = 1e-4   # per leaf, relative to its largest gradient
# ...except the timestep MLP, whose input is cos/sin of t * freq: XLA's and
# torch's fp32 exp round a frequency an ulp apart, which moves the argument
# at t ~ 999 by up to 2 ulps of 999 (tests/test_torch_models.py
# ::test_timestep_embedding_cos_first), and its weights' gradients are
# products with that input and with activations computed from it
T_EMB_RTOL = 2e-3


def _rtol(name):
    return T_EMB_RTOL if name.startswith("t_embedder.") else GRAD_RTOL


def _jax_params(dropout, backend="xla", remat=False, seed=0):
    model = JaxDiT(**CFG, class_dropout_prob=dropout, attn_backend=backend, remat=remat)
    n = CFG["input_size"]
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, n, n)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32)),
        params)
    return model, params


def _sd(tree):
    """A JAX param-shaped tree -> {torch name: fp32 numpy}."""
    sd = flax_params_to_state_dict(jax.tree.map(np.asarray, tree), CFG["patch_size"], 4,
                                   CFG["input_size"])
    return {k: v.numpy() for k, v in sd.items() if k != "pos_embed"}


def _port_model(params, dropout, remat=False):
    model = DiT(**CFG, class_dropout_prob=dropout, remat=remat, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(
        jax.tree.map(np.asarray, params), CFG["patch_size"], 4, CFG["input_size"]), strict=True)
    return model


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, 4, 8, 8).astype(np.float32),
            rs.randint(0, CFG["num_classes"], size=B).astype(np.int32))


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(got[k] - w).max() <= _rtol(k) * scale, k


def test_label_dropout_force_drop_ids_and_generator():
    jemb = JaxLabelEmbedder(10, 16, 0.1)
    labels = np.array([3, 7, 9, 0, 5], np.int32)
    fd = np.array([1, 0, 1, 0, 0], np.int32)
    jp = jemb.init(jax.random.PRNGKey(0), jnp.asarray(labels), False)
    want = np.asarray(jemb.apply(jp, jnp.asarray(labels), True, jnp.asarray(fd)))

    model = DiT(input_size=8, hidden_size=16, depth=1, num_heads=2, num_classes=10,
                device="cpu")
    emb = model.y_embedder
    with torch.no_grad():
        emb.embedding_table.weight.copy_(torch.from_numpy(
            np.asarray(jp["params"]["embedding_table"]["embedding"])))
    tl, tfd = torch.from_numpy(labels.astype(np.int64)), torch.from_numpy(fd.astype(np.int64))
    for train in (True, False):  # force_drop_ids drops in and out of training
        assert np.array_equal(emb(tl, train, tfd).detach().numpy(), want)
    # the forced drops win over the draw, whatever it is
    g = torch.Generator().manual_seed(0)
    assert torch.equal(emb.token_drop(tl, g, tfd), torch.tensor([10, 7, 10, 0, 5]))

    many = torch.arange(20000) % 10
    drops = [emb.token_drop(many, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(drops[0], drops[1]) and not torch.equal(drops[0], drops[2])
    frac = (drops[0] == 10).float().mean().item()
    assert abs(frac - 0.1) < 0.01  # 20000 draws: 4.7 sigma
    assert torch.equal(drops[0][drops[0] != 10], many[drops[0] != 10])
    assert torch.equal(emb(many, False), emb.embedding_table(many))  # no drop at eval


def test_one_step_loss_and_grads_match_jax_pallas_backward():
    jmodel, params = _jax_params(0.1, backend="hybrid", remat=True)
    x, y = _batch()
    rs = np.random.RandomState(2)
    # t >= 1: at t = 0 the decoder NLL of an untrained model sits in the tail
    # of its tanh CDF, where fp32 rounding decides the gradient
    # (tests/test_torch_losses.py covers that branch)
    t = rs.randint(1, 1000, size=B).astype(np.int32)
    noise = rs.randn(*x.shape).astype(np.float32)
    fd = np.array([1, 0, 0, 1], np.int32)
    jsched = jax_create_diffusion("").schedule

    def jloss(p):
        terms = jax_training_losses(
            jsched, lambda xt, tm: jmodel.apply(p, xt, tm, jnp.asarray(y), train=True,
                                                force_drop_ids=jnp.asarray(fd)),
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
        return terms["loss"].mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)

    model = _port_model(params, 0.1, remat=True)
    sched = create_diffusion("", device="cpu").schedule
    ty, tfd = torch.from_numpy(y.astype(np.int64)), torch.from_numpy(fd.astype(np.int64))
    terms = training_losses(sched, lambda xt, tm: model(xt, tm, ty, train=True,
                                                        force_drop_ids=tfd),
                            torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)),
                            torch.from_numpy(noise))
    loss = terms["loss"].mean()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    _assert_grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                        _sd(want_grads))


def test_remat_gives_the_same_gradients_and_refuses_unported_policies():
    # every policy of JAX's is ported: each gives no remat's gradients bit for
    # bit, in fp32 and bf16; a policy JAX lacks is refused
    for dtype in (torch.float32, torch.bfloat16):
        grads = []
        for remat, policy in ((False, "nothing"), (True, "nothing"), (True, "attn"),
                              (True, "attn_mlp")):
            model = DiT(**CFG, remat=remat, remat_policy=policy, dtype=dtype, device="cpu",
                        seed=3)
            x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
            model(x, torch.tensor([1, 500]), torch.tensor([2, 3]), train=True,
                  force_drop_ids=torch.tensor([0, 1])).square().sum().backward()
            grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
        assert all(torch.equal(grads[0], g) for g in grads[1:]), dtype
    with pytest.raises(ValueError, match="unknown remat policy"):
        DiT(**CFG, remat=True, remat_policy="dots", device="cpu")


def _jax_state(params, route):
    """The JAX train state and optax transform of one route, from `params`."""
    step0 = jnp.zeros((), jnp.int32)
    if route == "fused":
        p16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
        opt = jax_fused_init(p16, mu_dtype=jnp.bfloat16)
        return JaxTrainState(step=step0, params=p16, ema=jax.tree.map(jnp.copy, opt.master),
                             opt_state=opt), None
    tx = optax.adamw(LR, weight_decay=0.0)
    if route == "mixed":
        p16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
        tx = jax_masterize(tx)
        opt = tx.init(p16)
        return JaxTrainState(step=step0, params=p16, ema=jax.tree.map(jnp.copy, opt.master),
                             opt_state=opt), tx
    return JaxTrainState(step=step0, params=params, ema=jax.tree.map(jnp.copy, params),
                         opt_state=tx.init(params)), tx


def _jax_draws(rng, step, grad_accum):
    """t and noise as the JAX step draws them (`train_lib.py:216-231,239,256`)."""
    r = jax.random.fold_in(rng, step)
    mb = B // grad_accum
    draws = []
    for i in range(grad_accum):
        ri = r if grad_accum == 1 else jax.random.fold_in(r, i)
        rt, rn, _ = jax.random.split(ri, 3)
        draws.append({"t": torch.from_numpy(np.asarray(
                          jax.random.randint(rt, (mb,), 0, 1000)).astype(np.int64)),
                      "noise": torch.from_numpy(np.asarray(
                          jax.random.normal(rn, (mb, 4, 8, 8), jnp.float32)))})
    return draws


@pytest.mark.parametrize("route,grad_accum", [("default", 1), ("mixed", 1), ("fused", 1),
                                              ("default", 2)],
                         ids=["default", "mixed-precision", "fused-optimizer", "grad-accum-2"])
def test_two_train_steps_match_jax(route, grad_accum):
    jmodel, params = _jax_params(0.0)
    jsched = jax_create_diffusion("").schedule
    jstate, tx = _jax_state(params, route)
    jstep = jax.jit(jax_make_train_step(jmodel, jsched, tx, ema_decay=DECAY,
                                        grad_accum=grad_accum, log_grad_norm=True, lr=LR))
    model = _port_model(params, 0.0)
    state = create_train_state(model, lr=None if route == "fused" else LR,
                               mixed_precision=route == "mixed",
                               fused_optimizer=route == "fused")
    step = make_train_step(model, create_diffusion("", device="cpu").schedule, ema_decay=DECAY,
                           grad_accum=grad_accum, log_grad_norm=True, lr=LR)
    x, y = _batch()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y.astype(np.int64))}
    rng = jax.random.PRNGKey(0)
    for s in range(STEPS):
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, rng)
        m = step(state, batch, draws=_jax_draws(rng, s, grad_accum))
        for k in ("loss", "mse", "vb", "grad_norm"):
            # JAX takes the bf16 routes' gradient norm in bf16 (2^-8 relative)
            rtol = 2 ** -8 if k == "grad_norm" and route != "default" else LOSS_RTOL
            assert abs(m[k].item() - float(jm[k])) <= rtol * abs(float(jm[k])) + 1e-7, k
    assert state.step == int(jstate.step) == STEPS
    assert _build.launch_counts["fused_adamw_ema"] == 0  # the CPU takes the plain version

    bound = 2 * LR * STEPS
    names = [n for n, _ in model.named_parameters()]
    want_p = _sd(jstate.params)
    for n, p in model.named_parameters():
        got, want = p.detach().float().numpy(), want_p[n]
        assert p.dtype == (torch.float32 if route == "default" else torch.bfloat16)
        ulp = 0 if route == "default" else 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert (np.abs(got - want) <= np.maximum(bound, ulp)).all(), n
    want_e = _sd(jstate.ema)
    for n in names:
        assert np.abs(state.ema[n].numpy() - want_e[n]).max() <= (1 - DECAY) * bound + 1e-6, n

    if route == "fused":
        opt = jstate.opt_state
        got_mu, got_nu, got_master = state.opt.mu, state.opt.nu, state.opt.master
    else:
        inner = jstate.opt_state.inner if route == "mixed" else jstate.opt_state
        opt = inner[0]  # optax.adamw = chain(scale_by_adam, add_decayed_weights, scale)
        torch_opt = state.opt.inner if route == "mixed" else state.opt
        tensors = state.opt.master if route == "mixed" else list(model.parameters())
        got_mu = [torch_opt.state[t]["exp_avg"] for t in tensors]
        got_nu = [torch_opt.state[t]["exp_avg_sq"] for t in tensors]
        got_master = state.opt.master if route == "mixed" else None
    # the moments follow the gradients (nu their squares). On the bf16 routes
    # the second step's gradients are taken at bf16 parameters that may sit
    # one bf16 ulp (2^-8) apart after the first, and the fused route stores
    # mu in bf16: one bf16 ulp of the moments, 2^-7, bounds both
    for n, mu, nu in zip(names, got_mu, got_nu):
        rtol = _rtol(n) if route == "default" else 2 ** -7
        for g, w, tol in ((mu, _sd(opt.mu)[n], rtol), (nu, _sd(opt.nu)[n], 2 * rtol)):
            assert np.abs(g.float().numpy() - w).max() <= tol * np.abs(w).max(), n
    if got_master is not None:
        want_w = _sd(jstate.opt_state.master)
        for n, w in zip(names, got_master):
            assert np.abs(w.numpy() - want_w[n]).max() <= bound, n


@pytest.mark.parametrize("policy,nu", [("attn", None), ("attn_mlp", None), ("nothing", "bf16"),
                                       ("nothing", "factored"), ("attn_mlp", "factored")])
def test_two_train_steps_match_jax_under_remat_policies_and_nu_kinds(policy, nu):
    """JAX's step with `remat_policy` and, on the fused route, a bf16 or a
    factored nu, against the port's: losses and the gradient norm (fp32
    gradients: LOSS_RTOL; the fused route's bf16 gradients: 2^-8, as above),
    parameters, EMA and the second moment (bf16: one bf16 ulp of the moments,
    2^-7, as above; factored row and col: the means of squares of
    gradients that may sit one bf16 ulp apart, 2 x 2^-7)."""
    fused = nu is not None
    jmodel = JaxDiT(**CFG, class_dropout_prob=0.0, remat=True, remat_policy=policy)
    _, params = _jax_params(0.0)
    jsched = jax_create_diffusion("").schedule
    if fused:
        p16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
        opt = jax_fused_init(p16, mu_dtype=jnp.bfloat16,
                             nu_dtype=jnp.bfloat16 if nu == "bf16" else jnp.float32,
                             factored=nu == "factored")
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p16,
                               ema=jax.tree.map(jnp.copy, opt.master), opt_state=opt)
        tx = None
    else:
        jstate, tx = _jax_state(params, "default")
    jstep = jax.jit(jax_make_train_step(jmodel, jsched, tx, ema_decay=DECAY,
                                        log_grad_norm=True, lr=LR))
    model = _port_model(params, 0.0, remat=True)
    model.remat_policy = policy
    state = create_train_state(model, lr=None if fused else LR, fused_optimizer=fused,
                               nu_dtype=torch.bfloat16 if nu == "bf16" else None,
                               factored_nu=nu == "factored")
    step = make_train_step(model, create_diffusion("", device="cpu").schedule, ema_decay=DECAY,
                           log_grad_norm=True, lr=LR)
    x, y = _batch()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y.astype(np.int64))}
    rng = jax.random.PRNGKey(0)
    for s in range(STEPS):
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, rng)
        m = step(state, batch, draws=_jax_draws(rng, s, 1))
        for k in ("loss", "mse", "vb", "grad_norm"):
            rtol = 2 ** -8 if k == "grad_norm" and fused else LOSS_RTOL
            assert abs(m[k].item() - float(jm[k])) <= rtol * abs(float(jm[k])) + 1e-7, k

    bound = 2 * LR * STEPS
    want_p = _sd(jstate.params)
    for n, p in model.named_parameters():
        got, want = p.detach().float().numpy(), want_p[n]
        ulp = 0 if not fused else 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert (np.abs(got - want) <= np.maximum(bound, ulp)).all(), n
    want_e = _sd(jstate.ema)
    for n, e in state.ema.items():
        assert np.abs(e.numpy() - want_e[n]).max() <= (1 - DECAY) * bound + 1e-6, n
    if nu == "bf16":
        names = [n for n, _ in model.named_parameters()]
        want_nu = _sd(jstate.opt_state.nu)
        for n, v in zip(names, state.opt.nu):
            assert v.dtype == torch.bfloat16
            w = want_nu[n]
            assert np.abs(v.float().numpy() - w).max() <= 2 * 2 ** -7 * np.abs(w).max(), n
    elif nu == "factored":
        is_fnu = lambda n: isinstance(n, JaxFactoredNu)
        jnu = {"/".join(str(getattr(k, "key", k)) for k in path[1:]): leaf for path, leaf in
               jax.tree_util.tree_flatten_with_path(jstate.opt_state.nu, is_leaf=is_fnu)[0]}
        factored = {v.leaf.path: v for v in state.opt.nu if isinstance(v, FactoredNu)}
        assert factored and set(factored) == {k for k, v in jnu.items() if is_fnu(v)}
        for path, v in factored.items():
            for got, want in ((v.row, jnu[path].row), (v.col, jnu[path].col)):
                want = np.asarray(want)
                assert got.shape == want.shape
                assert np.abs(got.numpy() - want).max() <= 2 * 2 ** -7 * np.abs(want).max(), path


@pytest.mark.parametrize("kw", [{"lr": LR}, {"weight_decay": 0.0}], ids=["lr", "weight_decay"])
def test_fused_route_takes_lr_and_weight_decay_from_the_step_only(kw):
    # as in JAX (train_lib.py:88-92): the fused update reads them from
    # make_train_step, so create_train_state refuses them
    with pytest.raises(ValueError, match="make_train_step"):
        create_train_state(DiT(**CFG, device="cpu"), fused_optimizer=True, **kw)


def test_cli_trains_on_cpu_in_process_and_writes_a_loadable_checkpoint(tmp_path):
    args = cli.parse_args(["--device", "cpu", "--synthetic-data", "--model", "DiT-S/2",
                           "--max-steps", "2", "--global-batch-size", "4", "--log-every", "1",
                           "--results-dir", str(tmp_path / "results"), "--export-pt"])
    cli.main(args)
    (exp,) = (tmp_path / "results").iterdir()
    log = (exp / "log.txt").read_text()
    assert log.count("Train Loss") == 2 and "Train Steps/Sec" in log
    ckpt = torch.load(exp / "checkpoints" / "0000002.pt", weights_only=False)
    # the reference layout, and what a resume needs (tests/test_torch_resume.py)
    assert set(ckpt) == {"model", "ema", "opt", "args", "step", "sampler", "rng"}
    model = DiT(input_size=32, hidden_size=384, depth=12, num_heads=6, device="cpu")
    model.load_state_dict(ckpt["ema"], strict=True)
    model.load_state_dict(ckpt["model"], strict=True)
    assert any(not torch.equal(ckpt["model"][k], ckpt["ema"][k]) for k in ckpt["ema"])
    exported = torch.load(exp / "checkpoints" / "0000002-ema.pt")
    assert set(exported) == set(ckpt["ema"])
    assert all(torch.equal(exported[k], ckpt["ema"][k]) for k in exported)


MESH_FLAGS = ("--tp", "--ep")


@pytest.mark.parametrize("flags", [
    # every flag here is ported: --fsdp runs in a world of one process (a
    # data axis of 1, as in JAX), --tp 2 and --ep 2 need two ranks and are
    # refused in a world of one with JAX's reasons, naming no other flag
    # (their runs in a world of two: tests/test_torch_fsdp_tp.py,
    # tests/test_torch_expert_parallel.py); the other cases run one step on a
    # feature folder
    ["--resume", "--tp", "2"], ["--tp", "2"], ["--fsdp"], ["--ep", "2"], ["--native-loader"],
    ["--objective", "flow", "--resume", "--fsdp"],
    ["--schedule-sampler", "loss-second-moment", "--remat-policy", "attn_mlp", "--ep", "2"],
    ["--remat-policy", "attn", "--native-loader"],
    ["--fused-optimizer", "--nu-dtype", "bf16", "--tp", "2"],
    ["--fused-optimizer", "--factored-nu", "--fsdp"],
])
def test_cli_refuses_what_is_not_ported(flags, tmp_path):
    if not any(f in MESH_FLAGS for f in flags):
        feat = tmp_path / "features"
        rs = np.random.RandomState(0)
        for sub, arr in (("features", lambda: rs.randn(1, 4, 32, 32).astype(np.float32)),
                         ("labels", lambda: np.array([rs.randint(0, 1000)]))):
            (feat / f"imagenet256_{sub}").mkdir(parents=True)
            for i in range(2):
                np.save(feat / f"imagenet256_{sub}" / f"{i}.npy", arr())
        args = cli.parse_args(["--device", "cpu", "--feature-path", str(feat), "--model",
                               "DiT-S/8", "--global-batch-size", "2", "--max-steps", "1",
                               "--log-every", "1", "--results-dir", str(tmp_path / "r"), *flags])
        cli.main(args)
        (exp,) = (tmp_path / "r").iterdir()
        log = (exp / "log.txt").read_text()
        assert "Train Loss" in log
        assert ("--native-loader" in flags) == ("Using the native C++ feature loader" in log)
        return
    args = cli.parse_args(["--device", "cpu", "--synthetic-data", "--model", "DiT-S/2",
                           "--results-dir", str(tmp_path), *flags])
    want = ("1 ranks not divisible by model=2" if "--tp" in flags else
            r"--ep 2 must divide the model's expert count \(0\)")
    with pytest.raises(SystemExit, match=want) as e:
        cli.main(args)
    message = str(e.value)
    assert not any(f in message for f in flags if f.startswith("--") and f not in MESH_FLAGS)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("flags", [["--nu-dtype", "bf16"], ["--factored-nu"]])
def test_cli_refuses_nu_options_without_the_fused_optimizer(flags, tmp_path):
    # JAX's create_train_state raises for them (train_lib.py:101-104)
    args = cli.parse_args(["--device", "cpu", "--synthetic-data", "--model", "DiT-S/2",
                           "--results-dir", str(tmp_path), *flags])
    with pytest.raises(SystemExit, match="fused-optimizer features"):
        cli.main(args)
    assert not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="pass fused_optimizer=True"):
        create_train_state(DiT(**CFG, device="cpu"), nu_dtype=torch.bfloat16)


@pytest.mark.parametrize("flags", [
    ["--remat-policy", "attn"], ["--remat-policy", "attn_mlp"],
    ["--fused-optimizer", "--nu-dtype", "bf16"], ["--fused-optimizer", "--factored-nu"],
    ["--fused-optimizer", "--factored-nu", "--nu-dtype", "bf16", "--remat-policy", "attn"],
], ids=lambda f: "_".join(f).replace("-", ""))
def test_cli_runs_the_remat_policies_and_nu_kinds_on_cpu(flags, tmp_path, monkeypatch):
    # DiT-S/8 cut to 2 blocks: a 0.1 GB checkpoint file, not 0.5 (removed below)
    monkeypatch.setitem(cli.DiT_models, "DiT-S/8",
                        functools.partial(cli.DiT_models["DiT-S/8"], depth=2))
    args = cli.parse_args(["--device", "cpu", "--synthetic-data", "--model", "DiT-S/8",
                           "--max-steps", "2", "--global-batch-size", "4", "--log-every", "1",
                           "--results-dir", str(tmp_path / "results"), *flags])
    try:
        _check_cli_run(args, flags, tmp_path)
    finally:
        shutil.rmtree(tmp_path / "results", ignore_errors=True)


def _check_cli_run(args, flags, tmp_path):
    cli.main(args)
    (exp,) = (tmp_path / "results").iterdir()
    assert (exp / "log.txt").read_text().count("Train Loss") == 2
    ckpt = torch.load(exp / "checkpoints" / "0000002.pt", weights_only=False)
    assert ckpt["args"].remat_policy == args.remat_policy
    route = ckpt["opt"]["route"]
    if "--factored-nu" in flags:
        assert route == "fused/factored" and ckpt["opt"]["factored"]
        dense = [v for v in ckpt["opt"]["nu"] if v is not None]
        assert all(v.dtype == (torch.bfloat16 if "bf16" in flags else torch.float32)
                   for v in dense)
    elif "--nu-dtype" in flags:
        assert route == "fused/bfloat16"
    else:
        assert route == "adamw"


def test_cli_refuses_to_run_without_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    args = cli.parse_args(["--synthetic-data", "--model", "DiT-S/2", "--max-steps", "1",
                           "--results-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="CUDA is not available.*--device cpu"):
        cli.main(args)
    assert not list(tmp_path.iterdir())
