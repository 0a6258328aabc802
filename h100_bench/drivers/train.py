"""Training traffic: the trainer's own build (`train.cli.build`, the CLI's
flags) stepping back to back through a pool of batches made on the device
from the seed.

The pool holds, for each step, the latents, the labels and the step's
draws (timesteps, noise, label drops), handed to the step as its `draws`,
so that the reference can be given the same. The first `checked_steps`
steps are set-up: they go through the window's own call and feed on pool
entries whose rows all differ, and the program's readings are taken from
its state after them: each step's loss, each leaf's gradient norm in the
first step (from nu after one step, nu = (1 - b2) g^2), and each leaf's
change of the fp32 master and of the EMA over the checked steps. The
window goes on from that state.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import inputs
from ..reference import EXACT, Precision
from ..reference import train as ref_train
from ..reference.optim import B2
from ..reference.train import row_sq
from . import Outcome

__all__ = ["Session", "pool"]

# a row (output feature) of a leaf whose reference gradient is under this
# share of the median row's moves under Adam by round-off alone, as the key
# part of the packed qkv bias does under softmax; its change is not compared
NEGLIGIBLE_GRAD = 1e-3


def pool(cfg, tr, seed: int, device) -> dict:
    """{"x", "y", "t", "noise", "force_drop_ids"}, each (pool, batch, ...):
    N(0, 1) latents, uniform labels, uniform timesteps of the 1000-step
    process, N(0, 1) noise, label drops at the configuration's rate."""
    g = inputs.generator(seed, inputs.DATA, device)
    P, B, C = tr["pool"], tr["global_batch"], cfg["in_channels"]
    L = cfg["image_size"] // 8
    x = torch.randn((P, B, C, L, L), generator=g, device=device)
    y = torch.randint(0, cfg["num_classes"], (P, B), generator=g, device=device)
    t = torch.randint(0, tr["diffusion_steps"], (P, B), generator=g, device=device)
    noise = torch.randn((P, B, C, L, L), generator=g, device=device)
    drop = (torch.rand((P, B), generator=g, device=device) < cfg["class_dropout_prob"]).long()
    return {"x": x, "y": y, "t": t, "noise": noise, "force_drop_ids": drop}


def worst_leaf_gap(program, reference):
    """(gap, index) of the worst leaf: max over leaves of |program -
    reference| / max(reference, median of the reference's leaves)."""
    median = sorted(reference)[len(reference) // 2]
    return max((abs(p - r) / max(r, median), i)
               for i, (p, r) in enumerate(zip(program, reference)))


def _nu_rows(nu: torch.Tensor) -> torch.Tensor:
    """The first step's gradient, row by row, from nu after that step:
    nu = (1 - b2) g^2, so each row's sum of g^2 is its sum of nu / (1 - b2).
    b2 is the reference's; where the program's differs, the gradient read
    here is off by the ratio and the check fails."""
    return nu.double().reshape(nu.shape[0], -1).sum(dim=1).cpu() / (1 - B2)


class Session:
    def __init__(self, cell, device):
        from fast_dit_torch.train import cli  # noqa: PLC0415

        self.cfg, self.tr, self.device = cell.config, cell.traffic, torch.device(device)
        tr = self.tr
        argv = ["--model", self.cfg["model"], "--image-size", str(self.cfg["image_size"]),
                "--num-classes", str(self.cfg["num_classes"]),
                "--global-batch-size", str(tr["global_batch"]), "--lr", str(tr["lr"]),
                "--ema-decay", str(tr["ema_decay"]), "--remat-policy", tr["remat_policy"],
                "--device", str(self.device)] + tr["flags"]
        args = cli.parse_args(argv)
        cli.check_args(args)
        self.model, _, self.state, self.train_step = cli.build(args)
        inputs.check_structure(self.model, self.cfg)
        self.readings = None

    def _feed(self, k: int):
        i = k % self.tr["pool"]
        d = self.data
        return ({"x": d["x"][i], "y": d["y"][i]},
                [{"t": d["t"][i], "noise": d["noise"][i],
                  "force_drop_ids": d["force_drop_ids"][i]}])

    @torch.no_grad()
    def _load(self, w: dict) -> None:
        opt, ema = self.state.opt, self.state.ema
        for i, (name, p) in enumerate(self.model.named_parameters()):
            p.copy_(w[name])
            opt.master[i].copy_(w[name])
            ema[name].copy_(w[name])
            opt.mu[i].zero_()
            opt.nu[i].zero_()
        opt.count = 0
        self.state.step = 0

    def prepare(self, seed: int) -> None:
        """Weights and the pool from `seed`, then the checked steps."""
        self.seed = seed
        self._load(inputs.weights(self.cfg, seed, self.device, round_to=torch.bfloat16))
        self.data = pool(self.cfg, self.tr, seed, self.device)
        names = [n for n, _ in self.model.named_parameters()]
        losses, grad_rows = [], None
        for k in range(self.tr["checked_steps"]):
            losses.append(self.train_step(self.state, *self._feed(k))["loss"])
            if k == 0:  # nu = (1 - b2) g^2 after one step
                grad_rows = {n: _nu_rows(v) for n, v in zip(names, self.state.opt.nu)}
        w0 = inputs.weights(self.cfg, seed, self.device, round_to=torch.bfloat16)
        master = dict(zip(names, self.state.opt.master))
        self.readings = {
            "losses": [float(v) for v in losses], "grad_rows": grad_rows,
            "change_rows": {n: row_sq(master[n] - w0[n]) for n in names},
            "ema_change_rows": {n: row_sq(self.state.ema[n] - w0[n]) for n in names}}
        del w0
        _sync(self.device)

    def window(self, seconds: float, tracer) -> Outcome:
        B, losses = self.tr["global_batch"], []
        k = self.tr["checked_steps"]
        _sync(self.device)
        _reset_peak(self.device)
        t0 = time.perf_counter()
        tracer.start(seconds)
        while True:
            with tracer.span("train_step"):
                losses.append(self.train_step(self.state, *self._feed(k))["loss"])
            k += 1
            tracer.tick(len(losses))
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        window_s = time.perf_counter() - t0
        tracer.stop(len(losses))
        steps = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return Outcome(metrics={"train_images_per_s": B * steps / window_s}, attempted=steps,
                       failed=failed, t0=t0, window_s=window_s, steps=steps)

    def release(self) -> None:
        del self.model, self.state, self.train_step, self.data
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: Precision = EXACT) -> dict:
        """The reference's readings over the checked steps, from the seed."""
        w = inputs.weights(self.cfg, self.seed, self.device, round_to=torch.bfloat16)
        data = pool(self.cfg, self.tr, self.seed, self.device)
        steps = [{k: v[i] for k, v in data.items()} for i in range(self.tr["checked_steps"])]
        return ref_train.run_steps(self.cfg, w, steps, lr=self.tr["lr"],
                                   ema_decay=self.tr["ema_decay"],
                                   block_rows=self.tr["reference_block_rows"], prec=prec)

    def compare(self, ref: dict, prog: dict = None) -> dict:
        """The numbers that decide `correct` (see PERF.md): the worst step's
        relative loss gap, and by the worst leaf the gap of the first
        gradient's norm and of the master's and the EMA's change over the
        checked steps (rows whose reference gradient is negligible left out
        of the change)."""
        prog = prog or self.readings
        names = list(ref["grad_rows"])
        floor = NEGLIGIBLE_GRAD * torch.cat([ref["grad_rows"][n] for n in names]).sqrt().median()
        keep = {n: ref["grad_rows"][n].sqrt() >= floor for n in names}
        self.worst = {"rows_left_out": int(sum(int((~k).sum()) for k in keep.values()))}

        def gap(key, rows=None):
            def norms(d):
                return [float(d[n].sum() if rows is None else d[n][rows[n]].sum()) ** 0.5
                        for n in names]
            value, i = worst_leaf_gap(norms(prog[key]), norms(ref[key]))
            self.worst[key] = names[i] if i is not None else None
            return value

        return {"loss_rel_gap": max(abs(p - r) / abs(r)
                                    for p, r in zip(prog["losses"], ref["losses"])),
                "grad_norm_gap": gap("grad_rows"),
                "update_norm_gap": gap("change_rows", keep),
                "ema_update_norm_gap": gap("ema_change_rows", keep)}

    def compare_control(self, ref: dict, control: dict) -> dict:
        """The same numbers for the control's readings."""
        return self.compare(ref, control)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    """The window's memory peak is the run's: set-up transients are not."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
