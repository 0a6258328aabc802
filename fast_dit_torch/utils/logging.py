"""Logging and experiment-dir utilities (the port's own copy of
`fast_dit_tpu/utils/logging.py:19-61`).

The reference trainer's logger: on the main process, ANSI-coloured
timestamps to the console and plain ones to `log.txt`; a NullHandler
elsewhere. Experiment dirs are `{results}/{index:03d}-{model-name}` with an
auto-incremented index and a `checkpoints/` subdir; `--resume` re-enters
the highest-indexed one of the model (`find_latest_experiment_dir`).
"""

from __future__ import annotations

import logging
import os
from glob import glob

__all__ = ["create_logger", "make_experiment_dir", "find_latest_experiment_dir"]


def create_logger(logging_dir: str | None, *, is_main: bool = True) -> logging.Logger:
    """Coloured-timestamp logger on the main process, silent elsewhere."""
    logger = logging.getLogger(__name__)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if is_main:
        logger.setLevel(logging.INFO)
        fmt = logging.Formatter(
            "[\033[34m%(asctime)s\033[0m] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if logging_dir is not None:
            fh = logging.FileHandler(os.path.join(logging_dir, "log.txt"))
            fh.setFormatter(logging.Formatter(
                "[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def make_experiment_dir(results_dir: str, model_name: str) -> str:
    """`results/NNN-DiT-XL-2/` (with `checkpoints/`), NNN auto-incremented."""
    os.makedirs(results_dir, exist_ok=True)
    index = len(glob(f"{results_dir}/*"))
    exp_dir = f"{results_dir}/{index:03d}-{model_name.replace('/', '-')}"
    os.makedirs(os.path.join(exp_dir, "checkpoints"), exist_ok=True)
    return exp_dir


def find_latest_experiment_dir(results_dir: str, model_name: str) -> str | None:
    """The highest-indexed `NNN-{model}` dir under `results_dir`, or None."""
    safe = model_name.replace("/", "-")
    candidates = sorted(glob(f"{results_dir}/[0-9][0-9][0-9]-{safe}"))
    return candidates[-1] if candidates else None
