"""The port's flow matching (fast_dit_torch/diffusion/flow.py) and the flow
objective of its trainer, against the JAX package.

Paths, the loss, the time grid and the Euler and Heun chains over an
analytic velocity field written twice; a small learn_sigma=False DiT whose
weights cross with `flax_params_to_state_dict` for the CFG chain through the
sampler CLI's own functions; two train steps of the real JAX `make_train_step`
(objective="flow") against the port's, with t and noise drawn from the JAX
step's own key splits (`train_lib.py:216-231`) and injected; the trainer
CLI on the CPU.

Tolerances: coefficients and the loss 1e-6 relative (fp32 sin/cos on each
side's CPU library); the time grid equal; chains CHAIN_RTOL of max |JAX|;
DiT chains 1e-4 of max; training as tests/test_torch_train.py (loss and
gradient norm 1e-5 relative, Adam's moments 1e-4 of max per leaf, 2e-3 in
the timestep MLP, parameters 2 lr per step, the EMA (1 - decay) of that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_diffusion import CHAIN_RTOL
from test_torch_train import _rtol, _sd

import fast_dit_tpu.diffusion as jdiff
from fast_dit_tpu.models import DiT as JaxDiT
from fast_dit_tpu.train.train_lib import TrainState as JaxTrainState
from fast_dit_tpu.train.train_lib import make_train_step as jax_make_train_step
from fast_dit_torch import sample as sample_cli
from fast_dit_torch.ckpt import flax_params_to_state_dict
from fast_dit_torch.diffusion import (FLOW_PATHS, create_diffusion, flow_path_coeffs,
                                      flow_reverse_loop, flow_sample_loop, flow_training_losses)
from fast_dit_torch.diffusion.flow import flow_time_grid
from fast_dit_torch.models import DiT
from fast_dit_torch.train import cli, create_train_state, make_train_step
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

SHAPE = (2, 3, 4, 4)
COEF_RTOL = 1e-6
CFG = dict(input_size=8, patch_size=2, hidden_size=128, depth=2, num_heads=2, num_classes=10,
           learn_sigma=False)
LR, DECAY, STEPS, B = 1e-4, 0.9999, 2, 4
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_samplers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_velocity(x, t):
    a = jnp.cos(0.0021 * t.astype(jnp.float32) + 0.3)[:, None, None, None]
    return -0.7 * x * a + 0.2 * jnp.sin(1.5 * x)


def torch_velocity(x, t):
    a = torch.cos(0.0021 * t.float() + 0.3)[:, None, None, None]
    return -0.7 * x * a + 0.2 * torch.sin(1.5 * x)


def _z(shape=SHAPE, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("path", FLOW_PATHS)
def test_flow_path_coeffs_match_jax(path):
    t = np.linspace(0, 1, 37).astype(np.float32)
    for got, want in zip(flow_path_coeffs(torch.from_numpy(t), path),
                         jdiff.flow_path_coeffs(jnp.asarray(t), path)):
        assert got.dtype == torch.float32
        _close(got.numpy(), want, COEF_RTOL)


def test_unknown_flow_path_and_method_raise():
    with pytest.raises(NotImplementedError):
        flow_path_coeffs(torch.tensor([0.5]), "cosine")
    with pytest.raises(NotImplementedError):
        flow_sample_loop(torch_velocity, SHAPE, num_steps=2, method="rk4",
                         noise=torch.zeros(SHAPE))


@pytest.mark.parametrize("path", FLOW_PATHS)
def test_flow_training_losses_match_jax(path):
    rs = np.random.RandomState(1)
    x0, noise = _z(seed=1), _z(seed=2)
    t = rs.uniform(size=SHAPE[0]).astype(np.float32)
    want = jdiff.flow_training_losses(jax_velocity, jnp.asarray(x0), jnp.asarray(t),
                                      jnp.asarray(noise), path=path)
    got = flow_training_losses(torch_velocity, torch.from_numpy(x0), torch.from_numpy(t),
                               torch.from_numpy(noise), path=path)
    assert set(got) == set(want) == {"loss", "mse"}
    for k in want:
        _close(got[k].numpy(), want[k], COEF_RTOL)
    with pytest.raises(ValueError, match="learn_sigma=False"):
        flow_training_losses(lambda x, t: torch.cat([x, x], 1), torch.from_numpy(x0),
                             torch.from_numpy(t), torch.from_numpy(noise))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 10, 16, 20, 25, 50, 100, 250])
def test_flow_time_grid_equals_jnp_linspace(n):
    for start, stop in ((1.0, 0.0), (0.0, 1.0)):
        got = flow_time_grid(n, start, stop)
        want = np.asarray(jnp.linspace(start, stop, n + 1))
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def test_flow_time_grid_at_1000_steps_is_within_an_ulp_of_jnp_linspace():
    # XLA may round a time of the decreasing 1000-step grid one ulp apart
    for start, stop in ((1.0, 0.0), (0.0, 1.0)):
        got = flow_time_grid(1000, start, stop)
        want = np.asarray(jnp.linspace(start, stop, 1001))
        assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))
        assert got[0] == want[0] and got[-1] == want[-1]


@pytest.mark.parametrize("method", ["euler", "heun"])
@pytest.mark.parametrize("steps", [1, 7, 20])
def test_flow_sample_loop_matches_jax(method, steps):
    z = _z(seed=3)
    want, want_xs = jdiff.flow_sample_loop(jax_velocity, SHAPE, num_steps=steps, method=method,
                                           noise=jnp.asarray(z), return_intermediates=True)
    got, got_xs = flow_sample_loop(torch_velocity, SHAPE, num_steps=steps, method=method,
                                   noise=torch.from_numpy(z), return_intermediates=True)
    _close(got, want, CHAIN_RTOL)
    _close(got_xs, want_xs, CHAIN_RTOL)
    assert torch.equal(got_xs[-1], got)


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_flow_reverse_loop_matches_jax(method):
    x = _z(seed=4)
    want = jdiff.flow_reverse_loop(jax_velocity, jnp.asarray(x), num_steps=10, method=method)
    got = flow_reverse_loop(torch_velocity, torch.from_numpy(x), num_steps=10, method=method)
    _close(got, want, CHAIN_RTOL)


def test_heun_calls_the_model_twice_in_every_step_and_euler_once():
    calls = []

    def v(x, t):
        calls.append(float(t[0]))
        return torch.zeros_like(x)

    flow_sample_loop(v, SHAPE, num_steps=5, method="heun", noise=torch.zeros(SHAPE))
    grid = (flow_time_grid(5, 1.0, 0.0) * np.float32(1000.0)).tolist()
    assert calls == [t for pair in zip(grid[:-1], grid[1:]) for t in pair]  # the last at t = 0
    calls.clear()
    flow_sample_loop(v, SHAPE, num_steps=5, method="euler", noise=torch.zeros(SHAPE))
    assert calls == grid[:-1]
    g = torch.Generator().manual_seed(0)
    a = flow_sample_loop(torch_velocity, SHAPE, num_steps=2, generator=g)
    assert a.shape == SHAPE and torch.isfinite(a).all()


# -- a flow DiT: checkpoint, CFG over all channels, the CLI's chain -----------

def _jax_flow_params(cfg, seed=0, dropout=0.1, backend="xla"):
    model = JaxDiT(**cfg, class_dropout_prob=dropout, attn_backend=backend)
    n = cfg["input_size"]
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4, n, n)),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    rs = np.random.RandomState(seed)
    return model, jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(np.float32)),
        params)


def _port_flow_model(params, cfg, dropout=0.1):
    model = DiT(**cfg, class_dropout_prob=dropout, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.array, params),
                                                    cfg["patch_size"], 4, cfg["input_size"]),
                          strict=True)
    return model


def test_flow_checkpoint_crosses_and_cfg_guides_all_channels():
    """A learn_sigma=False JAX DiT's weights load strictly into the port's
    (4 output channels), and `forward_with_cfg(guidance_channels=4)` guides
    every channel as JAX's does."""
    jmodel, params = _jax_flow_params(CFG)
    model = _port_flow_model(params, CFG).eval()
    assert model.out_channels == 4
    rs = np.random.RandomState(5)
    x = np.concatenate([rs.randn(2, 4, 8, 8).astype(np.float32)] * 2)
    t = np.array([900.0, 900.0, 900.0, 900.0], np.float32)
    y = np.array([3, 7, 10, 10], np.int32)
    want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), 4.0,
                        method=jmodel.forward_with_cfg, guidance_channels=4)
    with torch.inference_mode():
        got = model.forward_with_cfg(torch.from_numpy(x), torch.from_numpy(t),
                                     torch.from_numpy(y.astype(np.int64)), 4.0,
                                     guidance_channels=4)
        plain = model.forward_with_cfg(torch.from_numpy(x), torch.from_numpy(t),
                                       torch.from_numpy(y.astype(np.int64)), 4.0)
    _close(got.numpy(), want, 1e-5)
    assert torch.equal(got[:, :3], plain[:, :3]) and not torch.equal(got[:, 3], plain[:, 3])


@pytest.mark.parametrize("sampler", ["euler", "heun"])
def test_flow_sampling_slice_matches_jax(sampler):
    """`python -m fast_dit_torch.sample --sampler {euler,heun}`'s chain
    (`make_model_fn` + `run_chain`, CFG 4.0 over all 4 channels) against the
    root `sample.py`'s flow path (`flow_sample_loop` over `forward_with_cfg`
    with `guidance_channels=in_channels`) on the same small flow DiT."""
    cfg = dict(CFG, hidden_size=64, num_classes=1000)
    jmodel, params = _jax_flow_params(cfg, seed=1)
    model = _port_flow_model(params, cfg).eval()
    args = sample_cli.parse_args(["--device", "cpu", "--sampler", sampler,
                                  "--num-sampling-steps", "6"])
    labels = [207, 88]
    y = np.array(labels + [1000] * 2, np.int32)
    z = np.concatenate([_z((2, 4, 8, 8), seed=6)] * 2)
    want = jdiff.flow_sample_loop(
        lambda x, t: jmodel.apply(params, x, t, jnp.asarray(y), 4.0,
                                  method=jmodel.forward_with_cfg, guidance_channels=4),
        z.shape, num_steps=6, method=sampler, noise=jnp.asarray(z))
    diffusion = sample_cli.build_diffusion(args, torch.device("cpu"))
    fn = sample_cli.make_model_fn(args, model, diffusion, torch.tensor(labels))
    with torch.inference_mode():
        got = sample_cli.run_chain(args, diffusion, fn, torch.from_numpy(z), None)
    _close(got[:2].numpy(), np.asarray(want)[:2], 1e-4)


# -- the trainer -----------------------------------------------------------------

def _flow_draws(rng, step):
    """t ~ U[0, 1) and the noise as the JAX flow step draws them."""
    r = jax.random.fold_in(rng, step)
    rt, rn, _ = jax.random.split(r, 3)
    return [{"t": torch.from_numpy(np.asarray(jax.random.uniform(rt, (B,), jnp.float32))),
             "noise": torch.from_numpy(np.asarray(jax.random.normal(rn, (B, 4, 8, 8),
                                                                     jnp.float32)))}]


@pytest.mark.parametrize("path", FLOW_PATHS)
def test_two_flow_train_steps_match_jax(path):
    jmodel, params = _jax_flow_params(CFG, dropout=0.0)
    tx = optax.adamw(LR, weight_decay=0.0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           ema=jax.tree.map(jnp.copy, params), opt_state=tx.init(params))
    jstep = jax.jit(jax_make_train_step(jmodel, jdiff.create_diffusion("").schedule, tx,
                                        ema_decay=DECAY, log_grad_norm=True, lr=LR,
                                        objective="flow", flow_path=path))
    model = _port_flow_model(params, CFG, dropout=0.0)
    state = create_train_state(model, lr=LR)
    step = make_train_step(model, create_diffusion("", device="cpu").schedule, ema_decay=DECAY,
                           log_grad_norm=True, lr=LR, objective="flow", flow_path=path)
    rs = np.random.RandomState(7)
    x = rs.randn(B, 4, 8, 8).astype(np.float32)
    y = rs.randint(0, 10, size=B).astype(np.int32)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y.astype(np.int64))}
    rng = jax.random.PRNGKey(3)
    for s in range(STEPS):
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, rng)
        m = step(state, batch, draws=_flow_draws(rng, s))
        assert set(m) == {"loss", "mse", "grad_norm"}
        for k in m:
            assert abs(m[k].item() - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k])), k
    bound = 2 * LR * STEPS
    want = flax_params_to_state_dict(jax.tree.map(np.array, jstate.params), 2, 4, 8)
    want_ema = flax_params_to_state_dict(jax.tree.map(np.array, jstate.ema), 2, 4, 8)
    for n, p in model.named_parameters():
        assert (p.detach() - want[n]).abs().max().item() <= bound, n
        assert (state.ema[n] - want_ema[n]).abs().max().item() <= (1 - DECAY) * bound + 1e-6, n
    # the moments follow the gradients (nu their squares)
    opt = jstate.opt_state[0]  # optax.adamw = chain(scale_by_adam, ...)
    want_mu, want_nu = _sd(opt.mu), _sd(opt.nu)
    for n, p in model.named_parameters():
        adam = state.opt.state[p]
        for got, w, tol in ((adam["exp_avg"], want_mu[n], _rtol(n)),
                            (adam["exp_avg_sq"], want_nu[n], 2 * _rtol(n))):
            assert np.abs(got.numpy() - w).max() <= tol * np.abs(w).max(), n


def test_flow_train_step_draws_continuous_t_from_the_generator():
    model = DiT(**CFG, device="cpu")
    g = torch.Generator().manual_seed(0)
    step = make_train_step(model, create_diffusion("", device="cpu").schedule,
                           objective="flow", generator=g)
    state = create_train_state(model)
    batch = {"x": torch.randn(B, 4, 8, 8, generator=torch.Generator().manual_seed(1)),
             "y": torch.tensor([1, 2, 3, 4])}
    m = step(state, batch)
    assert set(m) == {"loss", "mse"} and torch.isfinite(m["loss"])
    # the same draws, injected: t ~ U[0, 1) first, then the noise
    g2 = torch.Generator().manual_seed(0)
    t = torch.rand((B,), generator=g2)
    noise = torch.randn((B, 4, 8, 8), generator=g2)
    model2 = DiT(**CFG, device="cpu")
    step2 = make_train_step(model2, create_diffusion("", device="cpu").schedule,
                            objective="flow", generator=g2)
    m2 = step2(create_train_state(model2), batch, draws=[{"t": t, "noise": noise}])
    assert m2["loss"].item() == pytest.approx(m["loss"].item(), rel=1e-6)


def test_flow_train_step_refuses_a_loss_aware_sampler():
    from fast_dit_torch.diffusion import create_named_schedule_sampler

    model = DiT(**CFG, device="cpu")
    step = make_train_step(model, create_diffusion("", device="cpu").schedule,
                           objective="flow", generator=torch.Generator())
    state = create_train_state(model, sampler_state=create_named_schedule_sampler(
        "loss-second-moment", 1000))
    with pytest.raises(ValueError, match="continuous t"):
        step(state, {"x": torch.zeros(B, 4, 8, 8), "y": torch.zeros(B, dtype=torch.int64)})


def test_train_cli_objective_flow_on_cpu(tmp_path):
    args = cli.parse_args(["--device", "cpu", "--synthetic-data", "--model", "DiT-S/8",
                           "--objective", "flow", "--flow-path", "gvp", "--max-steps", "2",
                           "--global-batch-size", "4", "--log-every", "1",
                           "--results-dir", str(tmp_path / "results")])
    cli.main(args)
    (exp,) = (tmp_path / "results").iterdir()
    assert (exp / "log.txt").read_text().count("Train Loss") == 2
    ckpt = torch.load(exp / "checkpoints" / "0000002.pt", weights_only=False)
    model = DiT(input_size=32, patch_size=8, hidden_size=384, depth=12, num_heads=6,
                learn_sigma=False, device="cpu")
    model.load_state_dict(ckpt["ema"], strict=True)
    assert model.out_channels == 4


def test_train_cli_refuses_flow_with_the_loss_aware_sampler(tmp_path):
    args = cli.parse_args(["--device", "cpu", "--synthetic-data", "--model", "DiT-S/8",
                           "--objective", "flow", "--schedule-sampler", "loss-second-moment",
                           "--results-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--objective flow draws continuous t"):
        cli.main(args)
    assert not list(tmp_path.iterdir())
