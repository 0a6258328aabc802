"""The port stands alone: nothing in `fast_dit_torch/` or `chip_smoke.py`
imports JAX, flax, optax or the JAX package, and the package imports whole
in a process where JAX cannot be imported."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "fast_dit_tpu"}


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fast_dit_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_sources_exist():
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    for must in ("chip_smoke.py", "fast_dit_torch/__init__.py",
                 "fast_dit_torch/ops/flash_attention.py", "fast_dit_torch/sample.py",
                 "fast_dit_torch/ops/fused_update.py", "fast_dit_torch/train/__main__.py",
                 "fast_dit_torch/train/cli.py", "fast_dit_torch/train/train_lib.py",
                 "fast_dit_torch/train/mixed_precision.py", "fast_dit_torch/data/features.py",
                 "fast_dit_torch/utils/logging.py", "fast_dit_torch/ops/ring_attention.py",
                 "fast_dit_torch/parallel/__init__.py", "fast_dit_torch/parallel/sequence.py",
                 "fast_dit_torch/models/vae.py", "fast_dit_torch/ckpt/vae_import.py",
                 "fast_dit_torch/data/imagenet.py", "fast_dit_torch/extract_features.py",
                 "fast_dit_torch/sample_ddp.py", "fast_dit_torch/diffusion/flow.py",
                 "fast_dit_torch/diffusion/guidance_interval.py",
                 "fast_dit_torch/diffusion/timestep_samplers.py",
                 "fast_dit_torch/ckpt/checkpoint.py", "fast_dit_torch/ops/quant.py",
                 "fast_dit_torch/ops/tome.py", "fast_dit_torch/models/moe.py",
                 "fast_dit_torch/data/native_loader.py", "fast_dit_torch/utils/platform.py",
                 "fast_dit_torch/parallel/collectives.py", "fast_dit_torch/parallel/mesh.py",
                 "fast_dit_torch/ckpt/download.py", "fast_dit_torch/parallel/pipeline.py",
                 "fast_dit_torch/parallel/pipefusion.py", "fast_dit_torch/data/synthetic.py",
                 *(f"fast_dit_torch/nvs/{m}.py" for m in (
                     "__init__", "conditioning", "dino", "epipolar", "geometry", "inpaint",
                     "metrics", "pose_io", "warp")),
                 "fast_dit_torch/utils/viz.py", "fast_dit_torch/utils/video.py",
                 "fast_dit_torch/nvs_demo.py", "fast_dit_torch/evaluate_samples.py"):
        assert must in rel


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import fast_dit_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(fast_dit_torch.__path__, 'fast_dit_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(m.split('.')[0] in " f"{sorted(FORBIDDEN)!r}"
        " for m, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 28  # every module of the package was imported


def test_package_imports_without_pillow_or_safetensors():
    """The card's machine has neither: every module of the package, and
    chip_smoke.py, import with both blocked (Pillow is imported only inside
    the functions that decode images)."""
    blocked = ["PIL", "safetensors", *sorted(FORBIDDEN)]
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {blocked!r}: sys.modules[m] = None\n"
        "import fast_dit_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(fast_dit_torch.__path__, 'fast_dit_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 33
