"""The port's parity replay (fast_dit_torch/parity_check.py) on the bundles
committed in tests/fixtures, recorded from the upstream PyTorch reference's
own `p_sample_loop` and `ddim_sample_loop` (10 steps, squaredcos_cap_v2,
clip_denoised, a DiT of depth 2, width 32, 4 heads of 8, 8x8 latents,
`ref_bundle_model.pt`), at JAX's limit for the same replay (atol 2e-4,
tests/test_parity_harness.py). Measured on the CPU: max|Δ| 3.93e-6 (DDPM)
and 7.93e-6 (DDIM). The same chains, through the JAX package's loops with the
noise injected, agree with the port's within 5e-5 (measured 1.02e-5 on
DDPM: an untrained model with clipped x0 amplifies rounding from step to
step); a wrong `expected` fails with exit 1.
"""

import json
import os

import numpy as np
import pytest
import torch

from fast_dit_torch import parity_check
from test_torch_world import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
ATOL = 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(sampler, bundle=None, device="cpu"):
    with open(os.path.join(FIXTURES, f"ref_bundle_{sampler}_T10.json")) as f:
        meta = json.load(f)
    return ["--bundle", bundle or os.path.join(FIXTURES, f"ref_bundle_{sampler}_T10.npz"),
            "--ckpt", os.path.join(FIXTURES, "ref_bundle_model.pt"),
            "--model-config", json.dumps(meta["model_config"]), "--sampler", sampler,
            "--atol", str(ATOL), "--diffusion-steps", str(meta["T"]),
            "--noise-schedule", meta["schedule"], "--clip-denoised", "--device", device]


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_recorded_reference_bundle_replays_within_jax_limit(sampler, capsys):
    assert parity_check.main(_argv(sampler)) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("latent parity: max|Δ|=") and out[1] == "PARITY OK"
    res = parity_check.replay(parity_check.build_parser().parse_args(_argv(sampler)))
    assert res["ok"] and res["max_abs"] < 2e-5  # 4-8e-6 measured, far inside 2e-4
    assert res["latents"].shape == (2, 4, 8, 8)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_replay_equals_the_jax_loops(sampler):
    """The same bundle through JAX's model and loops (fp32, highest matmul
    precision, the noise injected) lands where the port's replay does."""
    import jax
    import jax.numpy as jnp

    from fast_dit_tpu.ckpt import find_model as jax_find_model
    from fast_dit_tpu.ckpt import state_dict_to_flax
    from fast_dit_tpu.diffusion import create_diffusion as jax_create_diffusion
    from fast_dit_tpu.models import DiT as JaxDiT

    with open(os.path.join(FIXTURES, f"ref_bundle_{sampler}_T10.json")) as f:
        meta = json.load(f)
    b = np.load(os.path.join(FIXTURES, f"ref_bundle_{sampler}_T10.npz"))
    model = JaxDiT(**meta["model_config"])
    sd = jax_find_model(os.path.join(FIXTURES, "ref_bundle_model.pt"))
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(sd, model.depth, model.num_heads))
    T = meta["T"]
    diffusion = jax_create_diffusion(str(T) if sampler == "ddpm" else f"ddim{T}",
                                     diffusion_steps=T, noise_schedule=meta["schedule"])
    loop = diffusion.p_sample_loop if sampler == "ddpm" else diffusion.ddim_sample_loop
    with jax.default_matmul_precision("highest"):
        want = np.asarray(loop(lambda x, t: model.apply(params, x, t, jnp.asarray(b["y"])),
                               b["x_T"].shape, noise=jnp.asarray(b["x_T"]),
                               step_noise=jnp.asarray(b["step_noise"]), clip_denoised=True))
    got = parity_check.replay(parity_check.build_parser().parse_args(_argv(sampler)))
    got = got["latents"].numpy()
    assert np.abs(got - want).max() <= 5e-5


def test_a_wrong_bundle_fails(tmp_path, capsys):
    b = dict(np.load(os.path.join(FIXTURES, "ref_bundle_ddpm_T10.npz")))
    b["expected"] = np.zeros_like(b["expected"])  # wrong on purpose
    path = str(tmp_path / "wrong.npz")
    np.savez(path, **b)
    assert parity_check.main(_argv("ddpm", bundle=path)) == 1
    assert capsys.readouterr().out.splitlines()[-1] == "PARITY FAILED"


def test_rtol_widens_the_bound_by_max_expected():
    args = parity_check.build_parser().parse_args(_argv("ddim") + ["--rtol", "0.5"])
    expected = np.load(os.path.join(FIXTURES, "ref_bundle_ddim_T10.npz"))["expected"]
    res = parity_check.replay(args)
    assert res["bound"] == pytest.approx(ATOL + 0.5 * np.abs(expected).max())


def test_cli_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = [a for a in _argv("ddpm") if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="CUDA is not available"):
        parity_check.main(argv)
