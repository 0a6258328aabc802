"""The port's timestep samplers (fast_dit_torch/diffusion/timestep_samplers.py)
and the loss-second-moment route of its trainer, against the JAX package.

- `update_with_losses`: the port folds a batch in with one scatter, JAX with
  a sequential scan; on batches with repeated timesteps and with wrap the
  ring buffers must be equal, value for value, round after round.
- `weights`: the same fp32 arithmetic, 1e-6 relative.
- `sample_timesteps`: torch's multinomial stream is not JAX's choice stream
  (a documented deviation); the port is held to its own contract (weights =
  1 / (T p[t]), an unbiased importance-weighted mean), and the train steps
  inject JAX's draws.
- Two train steps of the real JAX `make_train_step` with a warmed-up
  sampler state in its TrainState against the port's, grad_accum 1 and 2:
  t and the weights are drawn with JAX's keys from the JAX state each
  microbatch sees, then injected. Losses and the gradient norm 1e-5
  relative, Adam's moments as tests/test_torch_train.py holds them (the
  importance weights enter only the gradients), the loss history 1e-5 of
  max, the counts equal, parameters 2 lr per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (B, CFG, DECAY, LOSS_RTOL, LR, _batch, _jax_params, _port_model,
                              _rtol, _sd)

import fast_dit_tpu.diffusion as jdiff
from fast_dit_tpu.diffusion.gaussian import training_losses as jax_training_losses
from fast_dit_tpu.train.train_lib import TrainState as JaxTrainState
from fast_dit_tpu.train.train_lib import make_train_step as jax_make_train_step
from fast_dit_torch.diffusion import (LossSecondMomentState, UniformSamplerState,
                                      create_diffusion, create_named_schedule_sampler,
                                      sample_timesteps, update_with_losses)
from fast_dit_torch.train import cli, create_train_state, make_train_step
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

T, H = 1000, 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_samplers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(num_timesteps, history, counts=None, hist=None):
    ours = LossSecondMomentState.create(num_timesteps, history_per_term=history)
    theirs = jdiff.LossSecondMomentState.create(num_timesteps, history_per_term=history)
    if counts is not None:
        ours = LossSecondMomentState(torch.from_numpy(hist), torch.from_numpy(counts),
                                     num_timesteps, history, ours.uniform_prob)
        theirs = theirs.replace(loss_history=jnp.asarray(hist),
                                loss_counts=jnp.asarray(counts.astype(np.int32)))
    return ours, theirs


def _assert_same(ours, theirs):
    assert np.array_equal(ours.loss_history.numpy(), np.asarray(theirs.loss_history))
    assert np.array_equal(ours.loss_counts.numpy(), np.asarray(theirs.loss_counts))


def test_create_named_schedule_sampler():
    u = create_named_schedule_sampler("uniform", 7)
    assert isinstance(u, UniformSamplerState) and torch.equal(u.weights(), torch.ones(7))
    s = create_named_schedule_sampler("loss-second-moment", 7)
    j = jdiff.create_named_schedule_sampler("loss-second-moment", 7)
    assert (s.history_per_term, s.uniform_prob) == (j.history_per_term, j.uniform_prob)
    _assert_same(s, j)
    for make in (create_named_schedule_sampler, jdiff.create_named_schedule_sampler):
        with pytest.raises(NotImplementedError):
            make("nope", 7)
    assert update_with_losses(u, torch.tensor([1]), torch.tensor([2.0])) is u


@pytest.mark.parametrize("num_timesteps,history,batch,rounds,prefill", [
    (5, 3, 8, 6, False),      # repeats in every batch, wrap from the second round
    (3, 4, 20, 3, False),     # a timestep's batch losses overflow its row at once
    (4, 2, 4, 1, False),      # JAX's own case: [1, 1, 1, 1] keeps the last two
    (T, H, 32, 40, False),    # the trainer's shape
    (6, 5, 12, 4, True),      # rows partly filled already
    (2, 1, 5, 3, False),      # history of one
], ids=["repeats", "overflow-in-one-batch", "all-one-timestep", "trainer", "prefilled",
        "history-1"])
def test_update_with_losses_equals_the_sequential_jax_rule(num_timesteps, history, batch,
                                                          rounds, prefill):
    rs = np.random.RandomState(num_timesteps + history)
    counts = hist = None
    if prefill:
        counts = rs.randint(0, history + 1, size=num_timesteps).astype(np.int64)
        hist = np.where(np.arange(history)[None] < counts[:, None],
                        rs.uniform(0.1, 2.0, (num_timesteps, history)), 0).astype(np.float32)
    ours, theirs = _states(num_timesteps, history, counts, hist)
    for r in range(rounds):
        ts = (np.full(batch, 1) if num_timesteps == 4 else
              rs.randint(0, num_timesteps, size=batch)).astype(np.int64)
        losses = rs.uniform(0.1, 3.0, size=batch).astype(np.float32)
        if num_timesteps == 4:
            losses = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
        ours = update_with_losses(ours, torch.from_numpy(ts), torch.from_numpy(losses))
        theirs = jdiff.update_with_losses(theirs, jnp.asarray(ts), jnp.asarray(losses))
        _assert_same(ours, theirs)
    if num_timesteps == 4:
        assert ours.loss_history[1].tolist() == [3.0, 4.0]


def test_weights_match_jax_before_and_after_warm_up():
    rs = np.random.RandomState(1)
    hist = rs.uniform(0.1, 2.0, (T, H)).astype(np.float32)
    for counts in (np.full(T, H - 1, np.int64), np.full(T, H, np.int64)):
        ours, theirs = _states(T, H, counts, hist)
        got, want = ours.weights().numpy(), np.asarray(theirs.weights())
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert not np.allclose(got, got[0]) and abs(got.sum() - 1.0) < 1e-5


def test_sample_timesteps_weights_are_inverse_probabilities_and_unbiased():
    ours, _ = _states(T, 1, np.ones(T, np.int64),
                      np.linspace(0.5, 3.0, T).astype(np.float32)[:, None].copy())
    g = torch.Generator().manual_seed(0)
    ts, w = sample_timesteps(ours, g, 200_000)
    p = ours.weights() / ours.weights().sum()
    assert ts.dtype == torch.int64 and w.dtype == torch.float32
    assert torch.equal(w, 1.0 / (T * p[ts]))
    # E[w f(t)] under the sampler is the uniform mean of f (as tests/
    # test_timestep_samplers.py holds JAX's)
    est = (w.double() * ts.double()).mean().item()
    assert abs(est - (T - 1) / 2) <= 0.05 * (T - 1) / 2
    again = sample_timesteps(ours, torch.Generator().manual_seed(0), 200_000)
    assert torch.equal(again[0], ts)  # seeded


def _warm_states(seed=2):
    rs = np.random.RandomState(seed)
    hist = rs.uniform(0.05, 1.5, (T, H)).astype(np.float32)
    return _states(T, H, np.full(T, H, np.int64), hist)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_loss_second_moment_train_steps_match_jax(grad_accum):
    jmodel, params = _jax_params(0.0)
    jsched = jdiff.create_diffusion("").schedule
    import optax

    tx = optax.adamw(LR, weight_decay=0.0)
    port_sampler, jax_sampler = _warm_states()
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           ema=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                           sampler_state=jax_sampler)
    jstep = jax.jit(jax_make_train_step(jmodel, jsched, tx, ema_decay=DECAY,
                                        grad_accum=grad_accum, log_grad_norm=True, lr=LR))
    model = _port_model(params, 0.0)
    state = create_train_state(model, lr=LR, sampler_state=port_sampler)
    step = make_train_step(model, create_diffusion("", device="cpu").schedule,
                           ema_decay=DECAY, grad_accum=grad_accum, log_grad_norm=True, lr=LR)
    x, y = _batch()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y.astype(np.int64))}
    rng = jax.random.PRNGKey(0)
    mb = B // grad_accum
    for s in range(2):
        # JAX's draws (`train_lib.py:216-231`), each microbatch from the
        # sampler state the previous one left
        r = jax.random.fold_in(rng, s)
        samp, draws = jstate.sampler_state, []
        for i in range(grad_accum):
            ri = r if grad_accum == 1 else jax.random.fold_in(r, i)
            rt, rn, _ = jax.random.split(ri, 3)
            t, w = jdiff.sample_timesteps(samp, rt, mb)
            noise = jax.random.normal(rn, (mb, 4, 8, 8), jnp.float32)
            xi, yi = jnp.asarray(x[i * mb:(i + 1) * mb]), jnp.asarray(y[i * mb:(i + 1) * mb])
            per_example = jax_training_losses(
                jsched, lambda xt, tm: jmodel.apply(jstate.params, xt, tm, yi, train=True),
                xi, t, noise)["loss"]
            samp = jdiff.update_with_losses(samp, t, per_example)
            draws.append({"t": torch.from_numpy(np.asarray(t).astype(np.int64)),
                          "weights": torch.from_numpy(np.array(w)),
                          "noise": torch.from_numpy(np.array(noise))})
        assert not np.allclose(np.asarray(draws[0]["weights"]), 1.0)
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, rng)
        m = step(state, batch, draws=draws)
        for k in ("loss", "mse", "vb", "grad_norm"):
            assert abs(m[k].item() - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k])), k
    got, want = state.sampler_state, jstate.sampler_state
    assert np.array_equal(got.loss_counts.numpy(), np.asarray(want.loss_counts))
    wh = np.asarray(want.loss_history)
    assert np.abs(got.loss_history.numpy() - wh).max() <= 1e-5 * wh.max()
    assert not np.array_equal(wh, np.asarray(jax_sampler.loss_history))
    bound = 2 * LR * 2
    want_p = _sd(jstate.params)
    for n, p in model.named_parameters():
        assert np.abs(p.detach().numpy() - want_p[n]).max() <= bound, n
    # the moments follow the weighted gradients (nu their squares)
    opt = jstate.opt_state[0]  # optax.adamw = chain(scale_by_adam, ...)
    want_mu, want_nu = _sd(opt.mu), _sd(opt.nu)
    for n, p in model.named_parameters():
        adam = state.opt.state[p]
        for got, w, tol in ((adam["exp_avg"], want_mu[n], _rtol(n)),
                            (adam["exp_avg_sq"], want_nu[n], 2 * _rtol(n))):
            assert np.abs(got.numpy() - w).max() <= tol * np.abs(w).max(), n


def test_loss_second_moment_train_step_draws_from_its_state():
    """Without injected draws the step samples (t, weights) from the state
    with the generator, then folds the batch's losses back in."""
    model = _port_model(_jax_params(0.0)[1], 0.0)
    port_sampler, _ = _warm_states(seed=3)
    state = create_train_state(model, lr=LR, sampler_state=port_sampler)
    g = torch.Generator().manual_seed(5)
    step = make_train_step(model, create_diffusion("", device="cpu").schedule, lr=LR,
                           generator=g)
    x, y = _batch()
    m = step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y.astype(np.int64))})
    assert torch.isfinite(m["loss"])
    t, w = sample_timesteps(port_sampler, torch.Generator().manual_seed(5), B)
    assert torch.equal(state.sampler_state.loss_counts, port_sampler.loss_counts)  # all full
    changed = (state.sampler_state.loss_history != port_sampler.loss_history).any(dim=1)
    assert set(torch.nonzero(changed).flatten().tolist()) == set(t.tolist())


def test_train_cli_loss_second_moment_on_cpu(tmp_path):
    args = cli.parse_args(["--device", "cpu", "--synthetic-data", "--model", "DiT-S/8",
                           "--schedule-sampler", "loss-second-moment", "--max-steps", "2",
                           "--global-batch-size", "4", "--log-every", "1",
                           "--results-dir", str(tmp_path / "results")])
    model, diffusion, state, train_step = cli.build(args)
    assert isinstance(state.sampler_state, LossSecondMomentState)
    batch = next(next(cli.device_batches(args, torch.device("cpu"))))
    for _ in range(2):
        assert torch.isfinite(train_step(state, batch)["loss"])
    assert state.sampler_state.loss_counts.sum().item() == 8  # 2 steps of 4, not warmed up
    cli.main(args)
    (exp,) = (tmp_path / "results").iterdir()
    assert (exp / "log.txt").read_text().count("Train Loss") == 2
