"""The frozen reference against the port's plain path at a tiny size on
the CPU (this test imports both; the reference imports nothing of the
port)."""

import functools

import pytest
import torch

from h100_bench import inputs
from h100_bench.reference import EXACT, LOWER, diffusion, dit
from h100_bench.reference.optim import AdamWEma
from bench_tiny import tiny_files

FILES = tiny_files()
DENSE = FILES["h100_bench/configs/tiny_dense.json"]


def program_model(cfg, seed):
    from fast_dit_torch.models import DiT_models
    from fast_dit_torch.sample import load_dit

    ctor = functools.partial(DiT_models["DiT-S/2"], input_size=cfg["image_size"] // 8,
                             depth=cfg["depth"], hidden_size=cfg["hidden_size"],
                             num_heads=cfg["num_heads"], patch_size=cfg["patch_size"],
                             num_classes=cfg["num_classes"], dtype=torch.float32)
    w = inputs.weights(cfg, seed, "cpu")
    return load_dit(ctor, inputs.program_state_dict(cfg, w), "cpu"), w


@pytest.mark.parametrize("seed", [3, 4])
def test_forward_and_guided_forward_match_the_program(seed):
    cfg = DENSE
    model, w = program_model(cfg, seed)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 4, 32, 32, generator=g)
    t = torch.randint(0, 1000, (6,), generator=g)
    y = torch.randint(0, 1001, (6,), generator=g)
    with torch.no_grad():
        ours, theirs = dit.forward(w, cfg, x, t, y), model(x, t, y)
        assert torch.allclose(ours, theirs, rtol=1e-4, atol=1e-5)
        ours = dit.forward_with_cfg(w, cfg, x, t, y, 1.5)
        assert torch.allclose(ours, model.forward_with_cfg(x, t, y, 1.5), rtol=1e-4, atol=1e-5)
        # the control departs from the reference
        low = dit.forward(w, cfg, x, t, y, LOWER)
        assert (low - theirs).norm() / theirs.norm() > 1e-3


def test_pos_embed_is_the_programs():
    from fast_dit_torch.models.pos_embed import get_2d_sincos_pos_embed

    cfg = dict(DENSE, patch_size=2)
    assert torch.equal(dit.pos_embed(cfg)[0],
                       torch.from_numpy(get_2d_sincos_pos_embed(64, 16).astype("float32")))


def test_sampler_step_and_training_loss_match_the_program():
    from fast_dit_torch.diffusion import create_diffusion, gaussian

    g = torch.Generator().manual_seed(2)
    prog = create_diffusion("250", device="cpu").schedule
    ref = diffusion.Schedule(steps=250)
    assert ref.timestep_map == list(prog.timestep_map_host)
    x, out, noise = (torch.randn(4, 4, 8, 8, generator=g), torch.randn(4, 8, 8, 8, generator=g),
                     torch.randn(4, 4, 8, 8, generator=g))
    for i in (249, 120, 1, 0):
        t = torch.full((4,), i)
        theirs = gaussian.p_sample_step(prog, out, x, t, noise, clip_denoised=False).sample
        assert torch.allclose(diffusion.p_sample(ref, x, out, i, noise), theirs, atol=1e-6)
        assert not torch.allclose(diffusion.p_sample(ref, x, out, i, noise, LOWER), theirs,
                                  atol=1e-4)
    prog, ref = create_diffusion("", device="cpu").schedule, diffusion.Schedule()
    t = torch.tensor([0, 10, 500, 999])
    model = lambda x_t, t_: torch.tanh(torch.cat([x_t, x_t], 1) * 0.5)  # noqa: E731
    theirs = gaussian.training_losses(prog, model, x, t, noise)["loss"]
    assert torch.allclose(diffusion.training_loss(ref, model, x, t, noise), theirs, rtol=1e-5)


def test_adamw_ema_matches_the_programs_plain_update():
    from fast_dit_torch.ops.fused_update import fused_adamw_ema_apply, fused_adamw_ema_init

    g = torch.Generator().manual_seed(4)
    w = {"a": torch.randn(64, 8, generator=g).bfloat16().float(),
         "b": torch.randn(8, generator=g).bfloat16().float()}
    params = [v.bfloat16() for v in w.values()]
    state = fused_adamw_ema_init(params)
    ema = [v.clone() for v in state.master]
    ref = AdamWEma(w, lr=1e-2, ema_decay=0.99, prec=EXACT)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g).bfloat16() for p in params]
        fused_adamw_ema_apply(state, grads, params, ema, lr=1e-2, ema_decay=0.99)
        ref.step(dict(zip(w, grads)))
    for k, m, e in zip(w, state.master, ema):
        assert torch.allclose(ref.master[k], m, atol=1e-6)
        assert torch.allclose(ref.ema[k], e, atol=1e-6)
