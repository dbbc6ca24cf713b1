"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU silently."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chambers_tpu_torch
from chambers_tpu_torch import resolve_device
from chambers_tpu_torch.augmentations.augmentation_schemes import RandAugment
from chambers_tpu_torch.models.backbones import vision_transformer as tvit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "chambers_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's PyTorch CPU work on one thread, and restore the
    count after it. The suite runs modules side by side in several worker
    processes (pytest-xdist), and PyTorch's default of a thread a core in
    each of them oversubscribes the host, whose idle threads then spin
    beside the other workers. The port's test modules import this fixture;
    their results differ at most in float rounding, inside their
    tolerances, and a module's own bit-for-bit comparisons run both sides
    on the same count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        chambers_tpu_torch.__path__, "chambers_tpu_torch."))


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for name in ['chambers_tpu_torch'] + {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'chambers_tpu', 'optax', 'orbax', "
        "'msgpack', 'crc32c'))\n"
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
     if f.endswith(".py")] + [os.path.join(ROOT, name) for name in (
         "chip_smoke.py", "compare_flash_builds.py", "card_faults.py")]),
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    # JAX, the JAX package, and the packages the card's machine lacks
    assert not roots & {"jax", "jaxlib", "flax", "chambers_tpu", "optax",
                        "orbax", "msgpack", "crc32c"}, roots


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
    # the CNN backbones and their layers
    from chambers_tpu_torch.layers import convolution
    from chambers_tpu_torch.models.backbones import inception, resnext, senet

    small = senet.MODELS_PARAMS["seresnet50"]._replace(repetitions=(1,))
    for make in (lambda **kw: resnext.ResNeXt50(**kw),
                 lambda **kw: senet.SEResNet50(**kw),
                 lambda **kw: senet.SENet(small, **kw),
                 lambda **kw: inception.BNInception(**kw),
                 lambda **kw: convolution.Conv(3, 4, 3, **kw),
                 lambda **kw: convolution.BatchNorm(4, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for module in (senet.SENet(small, device="cpu"),
                   convolution.BatchNorm(4, device="cpu")):
        assert all(t.device.type == "cpu" for t in module.state_dict()
                   .values())


def test_not_yet_ported_paths_say_so(tmp_path, monkeypatch):
    from chambers_tpu_torch.layers.attention import (
        scaled_dot_product_attention,
    )
    from chambers_tpu_torch.augmentations.augmentation_schemes import (
        AutoAugment,
    )
    from chambers_tpu_torch.optimizers import AdamW
    from chambers_tpu_torch.quantization import QuantDense, quantize_model

    # the flash kernel is ported: the branch runs (on the CPU through its
    # plain version); the optimizers' mutable learning rate came with the
    # callbacks; data-parallel training and serving exports came with
    # item 8
    q = torch.zeros(1, 1, 2, 4)
    assert torch.equal(scaled_dot_product_attention(q, q, impl="flash"), q)
    with pytest.raises(ValueError, match="impl"):
        scaled_dot_product_attention(q, q, impl="pallas")
    opt = AdamW([torch.zeros(2, requires_grad=True)], weight_decay=1e-4,
                mutable_lr=True)
    assert opt.param_groups[0]["lr_scale"] == 1.0
    from chambers_tpu_torch.callbacks import ExperimentCallback
    from chambers_tpu_torch.training import Trainer
    from chambers_tpu_torch.utils import data

    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(QuantDense(2, 1, device="cpu"), loss=None, optimizer=None,
                mesh=object())
    cb = ExperimentCallback(str(tmp_path), serving_input_shape=(4,))
    assert cb.serving_input_shape == (4,)
    # the host data pipeline came with item 7
    assert data.valid_cardinality(data.pair_iteration_dataset(
        np.zeros((2, 1)), np.zeros((2, 1)), 1, 1)) is False
    # the int8 path and the whole-batch policies are ported
    dense = QuantDense(4, 3, device="cpu")
    dense.reset_parameters(torch.Generator().manual_seed(0))
    quantize_model(dense)
    assert dense.kernel.dtype == torch.int8
    assert dense(torch.zeros(2, 4)).shape == (2, 3)
    whole = AutoAugment()
    x = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    draws = whole.sample(2, torch.Generator().manual_seed(1), device="cpu")
    want = x
    for (op, _), stage in zip(whole.policies[draws["policy_idx"]],
                              draws["stages"]):
        if stage["do"]:
            want = whole._ops[op].apply(want, stage)
    assert torch.equal(whole.apply(x, draws), want)
    # released weights load from the cache directory; nothing is
    # downloaded, and a missing file is named
    monkeypatch.setenv("CHAMBERS_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError,
                       match="vitb16_imagenet_21k_1000_224.h5"):
        tvit.ViTB16(weights="imagenet21k+_224", device="cpu")


@pytest.mark.parametrize("module", ["flash_attention", "warp_kernels"])
def test_library_lists_every_source_it_is_built_from(module):
    """A library is rebuilt when the hash of its listed sources changes, so
    the list must name every file of ``csrc/`` that a listed source
    includes: an edited header that is not listed would leave a stale
    library in ``build/``."""
    import importlib
    import re

    from chambers_tpu_torch.ops import _build

    ops = importlib.import_module(f"chambers_tpu_torch.ops.{module}")
    sources = ops.LIBRARY[1]
    assert any(s.endswith(".cu") for s in sources)
    for name in sources:
        text = (_build.CSRC / name).read_text()
        for header in re.findall(r'#include\s+"([^"]+)"', text):
            assert header in sources, f"{name} includes {header}"


def test_every_cuda_source_is_in_a_library():
    """A source under ``csrc/`` that no library lists is never compiled."""
    from chambers_tpu_torch.ops import _build, flash_attention, warp_kernels

    listed = {s for library in (flash_attention.LIBRARY,
                                warp_kernels.LIBRARY) for s in library[1]}
    found = {p.name for p in _build.CSRC.iterdir()
             if p.suffix in (".cu", ".cuh")}
    assert found == listed


def _slice8_entry_points():
    from chambers_tpu_torch.layers.embedding import LearnedEmbedding0D
    from chambers_tpu_torch.layers.pooling import GlobalGeneralizedMean
    from chambers_tpu_torch.models.detection import DETR, build_detr

    small = dict(num_queries=4, embed_dim=8, num_heads=2, ff_dim=16,
                 num_encoder_layers=1, num_decoder_layers=1)
    return {
        "build_detr": lambda **kw: build_detr(3, input_shape=(32, 32, 3),
                                              **small, **kw),
        "DETR": lambda **kw: DETR(3, **small, **kw),
        "GlobalGeneralizedMean": lambda **kw: GlobalGeneralizedMean(**kw),
        "LearnedEmbedding0D": lambda **kw: LearnedEmbedding0D(4, **kw),
    }


@pytest.mark.parametrize("name", sorted(_slice8_entry_points()))
def test_detection_and_retrieval_modules_raise_without_a_card(name, no_cuda):
    make = _slice8_entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    module = make(device="cpu")
    assert all(p.device.type == "cpu" for p in module.parameters())


def test_matchers_answer_on_the_costs_device():
    """The auction runs where its costs are; the Hungarian matcher copies
    the costs to the host and its answer back."""
    from chambers_tpu_torch.losses import detection as det

    cost = torch.rand(2, 3, 5)
    for match in (det.auction_assignment, det.linear_sum_assignment):
        cols = match(cost)
        assert cols.device == cost.device and cols.dtype == torch.int64
        assert cols.shape == (2, 3)


def _init_names(path):
    """The names a package's ``__init__.py`` imports: its public list."""
    tree = ast.parse(open(path).read(), path)
    return {alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names}


def test_layers_export_the_jax_packages_names():
    """``chambers_tpu_torch.layers`` re-exports every name of
    ``chambers_tpu.layers``, the ``ops`` submodule and the mixture-of-experts
    layers included; the JAX list is read from its source, not imported."""
    import chambers_tpu_torch.layers as layers

    want = _init_names(os.path.join(ROOT, "chambers_tpu", "layers",
                                    "__init__.py"))
    assert {"MoEMLP", "MoEEncoderLayer", "MoEDecoderLayer", "moe_aux_loss",
            "ops", "MultiHeadAttention", "RMAC"} <= want
    assert _init_names(os.path.join(PKG, "layers", "__init__.py")) == want
    assert all(hasattr(layers, name) for name in want)
    assert layers.ops.__name__ == "chambers_tpu_torch.layers.ops"


def test_data_exports_the_jax_packages_names_and_imports_no_jax():
    """``chambers_tpu_torch.data`` exports exactly the names of
    ``chambers_tpu.data`` (read from its source, not imported), and no
    module of it, the native loaders included, imports JAX or the JAX
    package, even the JAX package's pure-numpy modules."""
    import chambers_tpu_torch.data as data

    want = _init_names(os.path.join(ROOT, "chambers_tpu", "data",
                                    "__init__.py"))
    assert {"Dataset", "InterleaveImageClassDataset", "device_prefetch",
            "tfrecord_to_dataset", "save_dataset"} <= want
    assert _init_names(os.path.join(PKG, "data", "__init__.py")) == want
    assert all(hasattr(data, name) for name in want)
    files = sorted(f for f in os.listdir(os.path.join(PKG, "data"))
                   if f.endswith(".py"))
    assert {"core.py", "dataset.py", "io.py", "native.py", "native_crc.py",
            "records.py", "persist.py", "tfrecord.py",
            "loader.py"} <= set(files)
    for f in files:
        names = list(_imports(os.path.join(PKG, "data", f)))
        assert not [n for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "chambers_tpu")
                    ], (f, names)


def test_vit_preprocess_input_is_bit_equal_to_jax():
    from chambers_tpu.models.backbones import vision_transformer as jvit

    x = np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    want = np.asarray(jvit.preprocess_input(x))
    got = tvit.preprocess_input(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def test_submodules_load_lazily_and_unported_ones_name_their_item():
    # every submodule is ported (item 8 brought parallel and serving): all
    # load lazily, an unknown name raises
    code = (
        "import sys, chambers_tpu_torch as c\n"
        "assert 'chambers_tpu_torch.losses' not in sys.modules\n"
        "assert c.losses is sys.modules['chambers_tpu_torch.losses']\n"
        "assert 'losses' in dir(c) and 'models' in dir(c)\n"
        "for name in ['callbacks', 'training', 'utils', 'serialization',\n"
        "             'data', 'parallel', 'serving']:\n"
        "    assert getattr(c, name) is sys.modules[f'chambers_tpu_torch.{name}']\n"
        "try:\n"
        "    c.no_such_module\n"
        "except AttributeError:\n"
        "    pass\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in sys.path if p]))
    out = subprocess.run([sys.executable, "-S", "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["parallel", "serving"])
def test_item_8_modules_have_the_jax_names(name):
    """``parallel`` exports exactly the names of the JAX package's
    ``parallel/__init__.py``; ``serving`` has its public functions and
    classes."""
    import importlib
    import inspect

    jax_module = importlib.import_module(f"chambers_tpu.{name}")
    port = importlib.import_module(f"chambers_tpu_torch.{name}")

    def public(module):
        return {n for n, v in vars(module).items() if not n.startswith("_")
                and not inspect.ismodule(v)
                and getattr(v, "__module__", module.__name__)
                .startswith(module.__name__.split(".")[0])}

    if name == "parallel":
        assert public(port) == public(jax_module)
    else:
        want = {n for n in public(jax_module)
                if getattr(vars(jax_module)[n], "__module__", "")
                == jax_module.__name__}
        assert want == {"export_serving_artifact", "load_serving_artifact",
                        "BatchedServer", "HTTPModelServer"}
        assert want <= public(port)
