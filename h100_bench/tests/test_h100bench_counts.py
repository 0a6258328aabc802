"""`counts.py` against values worked out by hand."""

import json

import pytest

from h100_bench import counts
from bench_tiny import BENCH

XL2 = json.loads((BENCH / "configs/dit_xl2_256.json").read_text())


def test_dit_xl2_blocks_are_118_4_g_multiply_adds():
    D, T = 1152, 256
    blocks = 28 * (4 * D * D * T + 8 * D * D * T + 2 * T * T * D)
    assert blocks == 118_380_036_096
    assert counts.tokens(XL2) == T
    # the blocks, adaLN, the embeddings and the final layer: the paper's 118.6 "Gflops"
    assert counts.forward_macs(XL2) == pytest.approx(118.6e9, rel=2e-3)
    assert counts.forward_macs(XL2) - blocks == 28 * 6 * D * D + 16 * T * D + 256 * D \
        + D * D + 2 * D * D + T * D * 32
    assert counts.forward_flops(XL2) == 2 * counts.forward_macs(XL2)
    assert counts.train_flops_per_image(XL2) == 3 * counts.forward_flops(XL2)


def test_sampling_step_flops_are_one_forward_of_the_doubled_batch():
    from h100_bench.cell import read_metric
    from h100_bench.trace import Window

    # 10 guided steps of 32 labels in 2 s: 640 forwards
    w = Window(kernels=[], copies=[], window_s=2.0, steps=10,
               shape={"config": XL2, "traffic": {"labels_per_chain": 32}})
    assert read_metric("mfu.sample", w) == pytest.approx(
        100 * 640 * 2 * counts.forward_macs(XL2) / (2.0 * 989e12))


def test_trainable_params_leave_out_the_position_table():
    # the reference's 675,129,632 counts the frozen (256, 1152) position table
    assert counts.trainable_params(XL2) == 675_129_632 - 256 * 1152 == 674_834_720


def test_kernel_bytes_and_flops():
    nbytes, flops = counts.attention_fwd(128, 256, 16, 72, with_lse=True)
    assert nbytes == 128 * 256 * 4 * 1152 * 2 + 4 * 128 * 256 * 16 == 304_087_040
    assert flops == 4 * 128 * 256 * 256 * 1152
    assert counts.attention_fwd(64, 256, 16, 72)[0] == 64 * 256 * 4 * 1152 * 2
    nbytes, flops = counts.attention_bwd(128, 256, 16, 72)
    assert nbytes == 128 * 256 * 8 * 1152 * 2 + 4 * 128 * 256 * 16
    assert flops == 10 * 128 * 256 * 256 * 1152
    # kernel 3: 32 bytes an element, 6.446 ms at 3.35 TB/s over DiT-XL/2
    n = counts.trainable_params(XL2)
    assert counts.adamw_ema_bytes(n) == 32 * n
    assert counts.bound_s(counts.adamw_ema_bytes(n), 0) * 1e3 == pytest.approx(6.446, abs=1e-3)
    # kernel 1 at the training shape is bound by its bytes
    assert counts.bound_s(*counts.attention_fwd(128, 256, 16, 72, with_lse=True)) == \
        pytest.approx(304_087_040 / 3.35e12)
