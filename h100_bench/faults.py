"""Faults planted in the program underneath a run, to show that the check
fails them: a step that returns its state unchanged, half of the batch
left out (the mean over the rest), an answer altered where it is produced,
and in sampling one token altered where the middle block produces it.
The cells are one card each, so no fault leaves out an exchange between
cards. Used by `calibrate.py` on the card and by the tests on the CPU."""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "planted"]

FAULTS = {"train": ("state_unchanged", "half_batch"),
          "sample": ("state_unchanged", "half_batch", "answer_altered", "token_altered")}


@contextlib.contextmanager
def _patch(obj, attr, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def _half(v):
    return v[: v.shape[0] // 2]


@contextlib.contextmanager
def planted(name: str, session):
    """`session` (a driver's Session) runs with fault `name` while open."""
    from fast_dit_torch.diffusion import gaussian  # noqa: PLC0415
    from fast_dit_torch.models.dit import DiT  # noqa: PLC0415
    from fast_dit_torch.models.layers import DiTBlock  # noqa: PLC0415
    from fast_dit_torch.train import train_lib  # noqa: PLC0415

    kind = type(session).__module__.rsplit(".", 1)[-1]
    if name not in FAULTS[kind]:
        raise ValueError(f"no fault {name!r} for {kind} traffic")
    if kind == "train" and name == "state_unchanged":
        with _patch(train_lib, "fused_adamw_ema_apply", lambda *a, **k: None):
            yield
    elif kind == "train":  # half_batch
        step = session.train_step

        def half(state, batch, draws):
            return step(state, {k: _half(v) for k, v in batch.items()},
                        [{k: _half(v) for k, v in d.items()} for d in draws])
        with _patch(session, "train_step", half):
            yield
    elif name == "state_unchanged":
        with _patch(gaussian, "p_sample_step",
                    lambda sched, out, x, *a, **k: gaussian.StepResult(x, x)):
            yield
    elif name == "half_batch":
        cfg_fwd = DiT.forward_with_cfg

        def half(self, x, *a, **k):
            out = cfg_fwd(self, x, *a, **k).clone()
            q = out.shape[0] // 4
            out[q:2 * q], out[3 * q:] = out[:q], out[2 * q:3 * q]
            return out
        with _patch(DiT, "forward_with_cfg", half):
            yield
    elif name == "token_altered":
        block_fwd = DiTBlock.forward_aux

        def altered_token(self, x, c, ring=None):
            out, aux = block_fwd(self, x, c, ring)
            blocks = session.model.blocks
            if self is blocks[len(blocks) // 2]:
                out = out.clone()
                out[0, 1] = -out[0, 1]  # the second token of the first row
            return out, aux
        with _patch(DiTBlock, "forward_aux", altered_token):
            yield
    else:  # answer_altered
        step = gaussian.p_sample_step

        def altered(*a, **k):
            res = step(*a, **k)
            sample = res.sample.clone()
            sample[0] += 0.5
            return res._replace(sample=sample)
        with _patch(gaussian, "p_sample_step", altered):
            yield
