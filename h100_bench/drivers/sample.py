"""FID-sampling traffic: chains back to back as `sample_ddp.generate` runs
them, without the decode: x_T and labels drawn uniformly from one
generator seeded from the seed, `sample.make_model_fn` (the guided doubled
batch), `sample.run_chain` (DDPM, its step noise from the same generator),
the first three channels quantised to uint8 and copied to the host at each
chain's end. The model is the sampler's build (`sample.load_dit`) of a
checkpoint the benchmark makes from the seed.

The benchmark's wrapper around the model function records a CUDA event at
every step boundary (a step is one guided model call and its DDPM update)
and closes the window at the first boundary past `--seconds`. It keeps, by
reference and without a copy, the tensors of the steps the check follows:
the window's first, a sample drawn from the seed, the last whole one and
the last of each finished chain. For each it keeps the input, the
respaced index, the timesteps and labels the model got, the generator's
state before the step's noise, the model's output and the next state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import random
import statistics
import time

import torch

from .. import inputs
from ..reference import EXACT, Precision
from ..reference import diffusion as ref_diffusion
from ..reference import dit as ref_dit
from ..reference.precision import no_tf32
from . import Outcome

__all__ = ["Session", "WindowClosed", "Kept", "WHOLE_FORWARD"]

# the numbers read from the whole guided forward (`_gaps`)
WHOLE_FORWARD = frozenset({"out_tok_p50", "out_tok_max", "out_row_l2"})


class WindowClosed(Exception):
    """Raised at the first step boundary past the window's end."""


@dataclasses.dataclass
class Kept:
    x: torch.Tensor
    i: int
    t: torch.Tensor
    yy: torch.Tensor
    gen_state: torch.Tensor
    out: torch.Tensor = None
    x_next: torch.Tensor = None
    images: torch.Tensor = None   # the chain's uint8 host copy, on a chain's last step
    # stage -> its input and output, at the steps the check follows stage by
    # stage (`Session._capture`)
    layers: dict = dataclasses.field(default_factory=dict)


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Session:
    def __init__(self, cell, device):
        from fast_dit_torch import sample, sample_ddp  # noqa: PLC0415
        from fast_dit_torch.models import DiT_models  # noqa: PLC0415
        from fast_dit_torch.utils.device import tf32  # noqa: PLC0415

        self.sample, self.sample_ddp = sample, sample_ddp
        self.cfg, self.tr, self.device = cell.config, cell.traffic, torch.device(device)
        # the whole guided forward is run by the reference where a limit reads it
        self.whole = bool(WHOLE_FORWARD & set(cell.limits))
        cfg, tr = self.cfg, self.tr
        argv = ["--model", cfg["model"], "--image-size", str(cfg["image_size"]),
                "--num-classes", str(cfg["num_classes"]), "--cfg-scale", str(tr["cfg_scale"]),
                "--num-sampling-steps", str(tr["sampling_steps"]),
                "--per-proc-batch-size", str(tr["labels_per_chain"]),
                "--device", str(self.device)] + tr["flags"]
        self.args = a = sample_ddp.build_parser().parse_args(argv)
        sample_ddp.check_args(a)
        self._tf32 = tf32(a.tf32)
        self._tf32.__enter__()
        self.ctor = functools.partial(
            DiT_models[a.model], input_size=a.image_size // 8, num_classes=a.num_classes,
            learn_sigma=cfg["learn_sigma"], dtype=torch.bfloat16 if a.bf16 else torch.float32,
            attn_backend=a.attn_backend, quant=a.quantize, tome_ratio=a.tome_ratio,
            tome_mlp=a.tome_mlp, seed=0, depth=cfg["depth"], hidden_size=cfg["hidden_size"],
            num_heads=cfg["num_heads"], patch_size=cfg["patch_size"])
        self.diffusion = sample.build_diffusion(a, self.device)
        self.model = None

    def prepare(self, seed: int) -> None:
        """The checkpoint from `seed`, loaded as the sampler loads one, then
        one chain stopped after `warmup_steps` and a chain's end, which warm
        every shape of the window."""
        self.seed = seed
        self.model = None
        gc.collect()
        sd = inputs.program_state_dict(self.cfg, inputs.weights(self.cfg, seed, self.device))
        self.model = self.sample.load_dit(self.ctor, sd, self.device)
        del sd
        inputs.check_structure(self.model, self.cfg)
        self._chains(deadline=None, max_steps=self.tr["warmup_steps"])
        n, L = self.args.per_proc_batch_size, self.args.image_size // 8
        with torch.inference_mode():
            x = torch.zeros(2 * n, self.model.in_channels, L, L, device=self.device)
            torch.isfinite(x[:n]).all()
            self.sample_ddp.quantize(x[:n][:, :3]).cpu()
        _sync(self.device)

    @torch.inference_mode()
    def _chains(self, deadline, max_steps=None, tracer=None, plan=()):
        """Chains back to back until the first step boundary past `deadline`
        (host clock) or after `max_steps` steps. Returns the CUDA events of
        each chain's step boundaries, the kept steps, and the counts: steps
        `k`, `finished` chains, steps of chains that ended non-finite (`bad`)."""
        a, n = self.args, self.args.per_proc_batch_size
        C, L = self.model.in_channels, a.image_size // 8
        T = self.diffusion.num_timesteps
        gen = inputs.generator(self.seed, inputs.CHAINS, self.device)
        span = tracer.span if tracer is not None else (lambda _: contextlib.nullcontext())
        events, kept = [], []
        st = {"k": 0, "prev": None, "finished": 0, "bad": 0}

        def wrap(model_fn, yy, chain_events):
            def step(x, t, **kw):
                if st["prev"] is not None:
                    st["prev"].x_next = x
                if (deadline is not None and time.perf_counter() >= deadline) or \
                        (max_steps is not None and st["k"] >= max_steps):
                    raise WindowClosed
                chain_events.append(_event(self.device))
                cur = Kept(x=x, i=T - len(chain_events), t=t, yy=yy, gen_state=gen.get_state())
                planned = st["k"] == 0 or st["k"] in plan
                with span("sample_step"), self._capture(cur.layers, planned):
                    cur.out = model_fn(x, t, **kw)
                if planned:
                    kept.append(cur)
                st["prev"] = cur
                st["k"] += 1
                if tracer is not None:
                    tracer.tick(st["k"])
                return cur.out
            return step

        while True:
            z = torch.randn(n, C, L, L, generator=gen, device=self.device)
            y = torch.randint(0, a.num_classes, (n,), generator=gen, device=self.device)
            yy = torch.cat([y, torch.full_like(y, a.num_classes)])
            model_fn = self.sample.make_model_fn(a, self.model, self.diffusion, y)
            chain_events = []
            events.append(chain_events)
            try:
                x = self.sample.run_chain(a, self.diffusion, wrap(model_fn, yy, chain_events),
                                          torch.cat([z, z], dim=0), gen)
            except WindowClosed:
                chain_events.append(_event(self.device))
                break
            chain_events.append(_event(self.device))
            with span("chain_end"):
                finite = torch.isfinite(x[:n]).all()
                images = self.sample_ddp.quantize(x[:n][:, :3]).cpu()
            last = st["prev"]
            last.x_next, last.images = x, images
            _keep(kept, last)  # a chain's last step
            st["prev"] = None
            st["finished"] += 1
            st["bad"] += 0 if bool(finite) else T
        if st["prev"] is not None:
            _keep(kept, st["prev"])  # the last whole step
        return events, kept, st

    @contextlib.contextmanager
    def _capture(self, store: dict, on: bool):
        """While open and `on`, keep (by reference, no copy) the input and
        output of every stage the check follows: the patch, timestep and
        label embeddings, the blocks `checked_blocks` names with their
        attention and MLP, the final layer, and the unguided output."""
        if not on:
            yield
            return
        m, handles, patched = self.model, [], []

        def hook(module, key, fn):
            handles.append(module.register_forward_hook(
                lambda mod, args, out: store.__setitem__(key, fn(args, out))))

        for b in self.tr["checked_blocks"]:
            block = m.blocks[b]

            def forward_aux(x, c, ring=None, _orig=block.forward_aux, _b=b):
                out = _orig(x, c, ring)
                store[("block", _b)] = (x, c, out[0])
                return out
            block.forward_aux = forward_aux
            patched.append(block)
            hook(block.attn, ("attn", b), lambda args, out: (args[0], out))
            hook(block.mlp, ("mlp", b), lambda args, out: (args[0], out[0] if isinstance(
                out, tuple) else out))
        hook(m.x_embedder, "x_embedder", lambda args, out: args[0])
        hook(m.t_embedder, "t_embedder", lambda args, out: (args[0], out))
        hook(m.y_embedder, "y_embedder", lambda args, out: (args[0], out))
        hook(m.final_layer, "final", lambda args, out: (args[0], args[1], out))
        hook(m, "raw", lambda args, out: out)
        try:
            yield
        finally:
            for h in handles:
                h.remove()
            for block in patched:
                del block.forward_aux

    def window(self, seconds: float, tracer) -> Outcome:
        n, T = self.args.per_proc_batch_size, self.diffusion.num_timesteps
        # the checked steps are drawn among the first chain's, which every
        # window finishes
        rng = random.Random(inputs.substream(self.seed, inputs.CHAINS))
        plan = set(rng.sample(range(1, T), self.tr["checked_steps"]))
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        tracer.start(seconds)
        events, kept, st = self._chains(t0 + seconds, tracer=tracer, plan=plan)
        _sync(self.device)
        window_s = time.perf_counter() - t0
        tracer.stop(st["k"])
        self.kept = kept
        step_ms = [e0.elapsed_time(e1) for ch in events for e0, e1 in zip(ch, ch[1:])
                   if e0 is not None]
        steps = st["k"]
        metrics = {"sample_images_per_s": n * steps / T / window_s}
        if step_ms:
            metrics["sample_step_ms_p95"] = statistics.quantiles(step_ms, n=20,
                                                                 method="inclusive")[18]
        return Outcome(metrics=metrics, attempted=steps, failed=st["bad"], t0=t0,
                       window_s=window_s, steps=steps, step_ms=step_ms, finished=st["finished"])

    def release(self) -> None:
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: Precision = EXACT, full: bool = None) -> dict:
        """For each kept step, what the reference gives at each stage from
        the program's input to that stage (`_stages`), and the step from
        the program's guided output with the step's noise, drawn again from
        the kept generator state. With `full` (by default, where the cell's
        limits read it), also the whole guided forward from the step's
        input."""
        full = self.whole if full is None else full
        W = inputs.weights(self.cfg, self.seed, self.device)
        sched = ref_diffusion.Schedule(steps=self.tr["sampling_steps"], device=self.device)
        outs = []
        with no_tf32(), torch.no_grad():
            for s in self.kept:
                t = torch.full((s.x.shape[0],), sched.timestep_map[s.i], device=self.device)
                g = torch.Generator(device=self.device)
                g.set_state(s.gen_state)
                noise = torch.randn(s.x.shape, generator=g, device=self.device)
                r = {"t": t, "x_next": ref_diffusion.p_sample(sched, s.x.float(), s.out.float(),
                                                              s.i, noise, prec)}
                if s.layers:
                    r.update(self._stages(W, s.layers, prec))
                if full:
                    r["out"] = ref_dit.forward_with_cfg(W, self.cfg, s.x.float(), t, s.yy,
                                                        self.tr["cfg_scale"], prec)
                outs.append(r)
        return {"steps": outs}

    def _stages(self, W, L: dict, prec: Precision) -> dict:
        f = lambda t: t.float()  # noqa: E731
        (tt, _), (yy, _) = L["t_embedder"], L["y_embedder"]
        r = {"embed": ref_dit.embed(W, self.cfg, tt, yy, prec),
             "patch": prec.act(ref_dit.patch_tokens(W, self.cfg, f(L["x_embedder"]), prec))}
        for b in self.tr["checked_blocks"]:
            x_in, c, _ = L[("block", b)]
            (h1, attn_out), (h2, mlp_out) = L[("attn", b)], L[("mlp", b)]
            stages = ref_dit.block_stages(W, self.cfg, b, f(x_in), f(c), f(h1), f(attn_out),
                                          f(h2), f(mlp_out), prec)
            r.update({(k, b): v for k, v in stages.items()})
        x_f, c_f, _ = L["final"]
        r["final"] = prec.act(ref_dit.final_layer(W, f(x_f), f(c_f), prec))
        dt = prec.state_dtype or torch.float32
        r["guided"] = ref_dit.guide(L["raw"].to(dt), self.tr["cfg_scale"]).float()
        return r

    def compare(self, ref: dict, kept=None) -> dict:
        """The numbers that decide `correct` (see PERF.md), each the largest
        over the kept steps: the stage-by-stage gaps (`_gaps`), the
        timesteps the model got that differ from the reference's, and on a
        chain's last step the uint8 values that differ from the program's
        final state quantised by the reference."""
        kept = kept or self.kept
        n = self.args.per_proc_batch_size
        numbers = _gaps([_program_stages(s, self.tr["checked_blocks"]) for s in kept],
                        ref["steps"])
        t_bad, q_bad = 0.0, 0
        for s, r in zip(kept, ref["steps"]):
            t_bad += float((s.t != r["t"]).sum())
            if s.images is not None:
                q = torch.clamp(127.5 * s.x_next[:n, :3].float() + 128.0, 0, 255)
                q_bad += int((q.to(torch.uint8).permute(0, 2, 3, 1).cpu() != s.images).sum())
        numbers.update(timestep_mismatch=t_bad, quantized_mismatch=float(q_bad))
        return numbers

    def compare_control(self, ref: dict, control: dict) -> dict:
        """The same gaps of the control's stages, from the same inputs."""
        return _gaps(control["steps"], ref["steps"])


def _program_stages(s: Kept, blocks) -> dict:
    """A kept step's program outputs under the keys `Session._stages` uses."""
    out = {"x_next": s.x_next, "out": s.out}
    L = s.layers
    if L:
        first = L[("block", blocks[0])]  # the conditioning c every block gets
        out.update(embed=first[1], patch=first[0] if blocks[0] == 0 else None,
                   final=L["final"][2], guided=s.out)
        for b in blocks:
            (h1, attn_out), (h2, mlp_out) = L[("attn", b)], L[("mlp", b)]
            out.update({("attn_in", b): h1, ("attn", b): attn_out, ("mlp_in", b): h2,
                        ("mlp", b): mlp_out, ("out", b): L[("block", b)][2]})
    return out


def _token_gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each token's relative L2 gap over the last axis, |a - b| / |b|."""
    a, b = a.float(), b.float()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-30)).flatten()


_TOKEN_STAGES = {"attn_in": "adaln_tok_p90", "mlp_in": "adaln_tok_p90",
                 "attn": "attn_tok_p90", "mlp": "mlp_tok_p90", "out": "residual_tok_p90"}


def _gaps(cands: list, refs: list) -> dict:
    """Each the largest over the kept steps and checked blocks: the 90th
    percentile of the tokens' relative gaps of each stage (both adaLN
    inputs, the attention, the MLP, the block output, the final layer, the
    patch tokens of block 0's input), the worst row's relative gap of the
    conditioning, the guidance and the step; with the whole forward, its
    median and worst token and its worst row."""
    out = {}

    def put(name, value):
        out[name] = max(out.get(name, 0.0), float(value))

    for c, r in zip(cands, refs):
        put("ddpm_step_gap", _worst_row(c["x_next"], r["x_next"]))
        for key, ref_out in r.items():
            if isinstance(key, tuple):
                tok = _token_gaps(c[key], ref_out)
                put(_TOKEN_STAGES[key[0]], tok.quantile(0.9))
                put(f"{key[0]}_tok_max", tok.max())  # recorded, not compared
        if "final" in r:
            put("final_tok_p90", _token_gaps(c["final"], r["final"]).quantile(0.9))
            put("embed_gap", _worst_row(c["embed"], r["embed"]))
            if c.get("patch") is not None:
                put("embed_gap", _token_gaps(c["patch"], r["patch"]).quantile(0.9))
            put("cfg_gap", _worst_row(c["guided"], r["guided"]))
        if "out" in r:
            tok = _token_gaps(c["out"].movedim(1, -1), r["out"].movedim(1, -1))
            put("out_tok_p50", tok.median())
            put("out_tok_max", tok.max())
            put("out_row_l2", _worst_row(c["out"], r["out"]))
    return out


def _keep(kept: list, step: Kept) -> None:
    if all(k is not step for k in kept):
        kept.append(step)


def _worst_row(a: torch.Tensor, b: torch.Tensor) -> float:
    """max over rows of ||a - b|| / ||b||."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30)).max())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
