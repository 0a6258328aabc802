"""What the benchmark makes from `--seed`: the weights and the data, on the
device, in a few large calls. The program and the reference are handed the
same."""

from __future__ import annotations

import math

import torch

from .reference import dit as ref_dit

__all__ = ["substream", "generator", "weights", "program_state_dict", "check_structure"]

# the independent streams drawn from one seed
WEIGHTS, DATA, CHAINS = 1, 2, 3


def substream(seed: int, stream: int) -> int:
    """A generator seed for one stream of `seed` (any int up to 2**63)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0x632BE59BD9B4E019) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(substream(seed, stream))


def weights(cfg, seed: int, device, round_to=None) -> dict:
    """name -> fp32 tensor: every parameter of `cfg` drawn from N(0, std^2)
    in one call (`reference.dit.param_specs`), the values rounded to
    `round_to` where the configuration stores them so. The tensors are views
    of one buffer."""
    specs = ref_dit.param_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    views = list(flat.split(sizes))
    torch._foreach_mul_(views, [float(std) for _, _, std in specs])
    if round_to is not None:
        flat.copy_(flat.to(round_to))
    return {name: v.view(shape) for (name, shape, _), v in zip(specs, views)}


def program_state_dict(cfg, w: dict) -> dict:
    """A checkpoint of `w` as the program loads one: the parameters and the
    frozen position table."""
    sd = dict(w)
    sd["pos_embed"] = ref_dit.pos_embed(cfg).to(next(iter(w.values())).device)
    return sd


def check_structure(model, cfg) -> None:
    """Raise unless the program's parameters are the configuration's, name
    for name and shape for shape."""
    want = {n: tuple(s) for n, s, _ in ref_dit.param_specs(cfg)}
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise RuntimeError(f"the program's parameters differ from the configuration's: {diff}")
