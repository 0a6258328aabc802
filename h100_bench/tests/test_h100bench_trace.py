"""The per-layer metrics' arithmetic on a synthetic traced window."""

import json

import pytest

from h100_bench import cell
from h100_bench.trace import Window, _gaps, union_ns
from bench_tiny import BENCH

CFG = json.loads((BENCH / "configs/dit_xl2_256.json").read_text())
TRAIN = json.loads((BENCH / "traffic/train_b128.json").read_text())
MS = 1_000_000


def window(kernels, copies=(), steps=2, window_s=0.010, step_ms=()):
    w = Window(kernels=[k[:3] for k in kernels], copies=list(copies))
    w.steps, w.window_s, w.step_ms = steps, window_s, list(step_ms)
    w.shape = {"config": CFG, "traffic": TRAIN}
    return w


def test_union_of_overlapping_intervals():
    assert union_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert union_ns([]) == 0


def test_idle_share_from_the_union_of_device_intervals():
    w = window([("k1", 0, 2 * MS, ()), ("k2", 1 * MS, 3 * MS, ()), ("k3", 6 * MS, 7 * MS, ())],
               copies=[("Memcpy HtoD", 8 * MS, 9 * MS)])
    assert w.busy_s == pytest.approx(0.005)
    assert cell.read_metric("device_idle_pct.train", w) == pytest.approx(50.0)


def test_gemm_pattern_that_matches_nothing_raises():
    w = window([("elementwise_kernel", 0, MS, ())])
    with pytest.raises(RuntimeError, match="no kernel matches"):
        cell.read_metric("gemm_ms_per_step.train", w)
    w = window([("sm90_xmma_gemm_bf16bf16", 0, 3 * MS, ()),
                ("nvjet_hsh_128x256", 3 * MS, 4 * MS, ())])
    assert cell.read_metric("gemm_ms_per_step.train", w) == pytest.approx(2.0)


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = window([])
    for name in ("kernels_per_step.train", "gemm_ms_per_step.train", "attn_roofline.train",
                 "adamw_ema_roofline.train", "device_idle_pct.train",
                 "step_ms_p50.sample"):
        assert cell.read_metric(name, empty) is None, name


def test_rooflines_and_kernel_counts():
    k = [("void attention_fwd_bf16_kernel<72>", 0, 200_000, ()),
         ("void attention_bwd_dq_bf16_kernel<72>", 0, 500_000, ("train_step",)),
         ("void attention_bwd_dkv_bf16_kernel<72>", 0, 500_000, ("train_step",)),
         ("void fused_adamw_ema_kernel<bf16>", 0, 9_000_000, ()),
         ("gather", 0, 1_000_000, ())]
    w = window(k, steps=1)
    assert w.kernel_count("attention_bwd") == 2
    fwd = max(304_087_040 / 3.35e12, 4 * 128 * 256 * 256 * 1152 / 989e12)
    bwd = max((128 * 256 * 8 * 1152 * 2 + 4 * 128 * 256 * 16) / 3.35e12,
              10 * 128 * 256 * 256 * 1152 / 989e12)
    assert cell.read_metric("attn_roofline.train", w) == pytest.approx(
        100 * (fwd + bwd) / 1.2e-3)
    assert cell.read_metric("adamw_ema_roofline.train", w) == pytest.approx(
        100 * 32 * 674_834_720 / 3.35e12 / 9e-3)
    assert cell.read_metric("kernels_per_step.train", w) == 5


def test_mfu_and_step_median():
    w = window([("k", 0, MS, ())], steps=4, window_s=2.0, step_ms=[1.0, 3.0, 2.0])
    flops = 3 * 2 * 118_622_000_000
    assert cell.read_metric("mfu.train", w) == pytest.approx(
        100 * 128 * 4 * flops / (2.0 * 989e12), rel=1e-3)
    assert cell.read_metric("step_ms_p50.sample", w) == 2.0


def test_idle_gaps_are_labelled_by_the_host_op_after_them():
    gaps = _gaps([(0, 10, "a"), (20, 30, "step/aten::mm"), (25, 40, "b"),
                  (50, 60, "step/aten::mm")])
    assert gaps[0] == ["step/aten::mm", 20 / 1e9]
