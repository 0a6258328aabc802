"""The port's procedural shapes dataset (fast_dit_torch/data/synthetic.py),
its own numpy copy, against the JAX package's (fast_dit_tpu/data/synthetic.py):
byte-equal arrays for equal arguments, and the same refusals."""

import numpy as np
import pytest

from fast_dit_torch.data import synthetic
from fast_dit_tpu.data import synthetic as jax_synthetic


def test_constants_and_class_colors_equal_jax():
    assert synthetic.NUM_CLASSES == jax_synthetic.NUM_CLASSES == 10
    assert synthetic.CLASS_NAMES == jax_synthetic.CLASS_NAMES
    for k in (10, 7, 1000):
        a, b = synthetic.class_colors(k), jax_synthetic.class_colors(k)
        assert a.dtype == b.dtype and a.shape == b.shape == (k, 3)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,size,n", [(0, 32, 20), (7, 16, 13), (123, 64, 10),
                                         (2 ** 31 - 1, 8, 3)])
def test_synth_batch_is_byte_equal_to_jax(seed, size, n):
    labels = np.random.default_rng(seed).integers(0, 10, n)
    a = synthetic.synth_batch(labels, seed, image_size=size)
    b = jax_synthetic.synth_batch(labels, seed, image_size=size)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (n, 3, size, size)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,num,size", [(0, 40, 32), (5, 11, 16), (9, 30, 8)])
def test_synth_dataset_is_byte_equal_to_jax(seed, num, size):
    (xa, ya), (xb, yb) = (mod.synth_dataset(num, seed, image_size=size)
                          for mod in (synthetic, jax_synthetic))
    assert ya.dtype == yb.dtype and np.array_equal(ya, yb)
    assert xa.tobytes() == xb.tobytes()
    # given labels are kept as they are
    labels = np.arange(num) % 3
    (xa, ya), (xb, yb) = (mod.synth_dataset(num, seed, size, labels=labels)
                          for mod in (synthetic, jax_synthetic))
    assert ya is labels and xa.tobytes() == xb.tobytes()


@pytest.mark.parametrize("labels,match", [(np.zeros((2, 2), np.int64), "1-D"),
                                          (np.array([0, 10]), r"\[0, 10\)"),
                                          (np.array([-1]), r"\[0, 10\)")])
def test_synth_batch_refuses_what_jax_refuses(labels, match):
    for mod in (synthetic, jax_synthetic):
        with pytest.raises(ValueError, match=match):
            mod.synth_batch(labels, 0)
