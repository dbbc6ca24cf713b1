"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU silently."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import chambers_tpu_torch
from chambers_tpu_torch import resolve_device
from chambers_tpu_torch.augmentations.augmentation_schemes import RandAugment
from chambers_tpu_torch.models.backbones import vision_transformer as tvit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "chambers_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        chambers_tpu_torch.__path__, "chambers_tpu_torch."))


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for name in ['chambers_tpu_torch'] + {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'chambers_tpu'))\n"
        "print(','.join(bad))\n"
    )
    # -S: no site hooks, so nothing imports JAX before the port does
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in sys.path if p]))
    out = subprocess.run([sys.executable, "-S", "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "flax", "chambers_tpu"}, roots


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvit.ViTS16(input_shape=(32, 32, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RandAugment(2, 10, elementwise=True).sample(2, (8, 8))
    assert resolve_device("cpu") == torch.device("cpu")
    model = tvit.ViTS16(input_shape=(32, 32, 3), classes=3, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_not_yet_ported_paths_say_so():
    from chambers_tpu_torch.layers.attention import (
        scaled_dot_product_attention,
    )
    from chambers_tpu_torch.quantization import QuantDense

    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(NotImplementedError, match="later slice"):
        scaled_dot_product_attention(q, q, impl="flash")
    dense = QuantDense(4, 3, device="cpu")
    dense.kernel_scale = torch.ones(1, 3)
    with pytest.raises(NotImplementedError, match="int8"):
        dense(torch.zeros(2, 4))
    with pytest.raises(NotImplementedError, match="weights"):
        tvit.ViTB16(weights="imagenet21k+_224", device="cpu")
