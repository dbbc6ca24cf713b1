"""The port's utilities (``chambers_tpu_torch.utils``) against the JAX
package's: parameter paths, the tensor and ranking helpers, the generic
helpers, profiling, and the Flax msgpack reader and writer against
``flax.serialization``."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from chambers_tpu.utils import generic as jgeneric
from chambers_tpu.utils import pytree as jpytree
from chambers_tpu.utils import ranking as jranking
from chambers_tpu.utils import tensor as jtensor
from chambers_tpu_torch.utils import generic, msgpack_io, profiling, pytree
from chambers_tpu_torch.utils import ranking, tensor
from test_torch_package import one_torch_thread  # noqa: F401


# --- pytree --------------------------------------------------------------------

def test_param_paths_of_a_nested_dict_equal_jax():
    tree = {"encoder": {"layers_1": {"w": 1, "b": 2}, "layers_0": {"w": 3}},
            "head": {"kernel": 4}, "a": [5, {"x": 6}]}
    assert pytree.param_paths(tree) == jpytree.param_paths(tree)


def test_param_paths_of_a_module_are_the_jax_paths():
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    vit = VisionTransformer(16, 32, 2, 2, 64, image_size=(32, 32),
                            classes=3, device="cpu")
    paths = pytree.param_paths(vit)
    assert "encoder/layers_1/multi_head_attention/w_query" in paths
    assert len(paths) == len(list(vit.parameters()))


# --- tensor helpers --------------------------------------------------------------

@pytest.mark.parametrize("axis,indices", [(0, [1, 3]), (1, [0]),
                                          (1, [4, 2, 0])])
def test_remove_indices_equals_jax(axis, indices):
    x = np.arange(30, dtype=np.float32).reshape(6, 5)
    np.testing.assert_array_equal(
        tensor.remove_indices(torch.from_numpy(x), indices, axis).numpy(),
        np.asarray(jtensor.remove_indices(jnp.asarray(x), indices, axis)))


@pytest.mark.parametrize("shape", [(4, 4), (3, 5)])
def test_remove_diagonal_equals_jax(shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(
        tensor.remove_diagonal(torch.from_numpy(x)).numpy(),
        np.asarray(jtensor.remove_diagonal(jnp.asarray(x))))


def test_gather_helpers_equal_jax():
    rng = np.random.RandomState(0)
    mat = rng.randn(4, 6).astype(np.float32)
    idx = rng.randint(0, 6, (4, 3))
    np.testing.assert_array_equal(
        tensor.arg_to_gather_nd(torch.from_numpy(idx)).numpy(),
        np.asarray(jtensor.arg_to_gather_nd(jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tensor.take_along_rows(torch.from_numpy(mat),
                               torch.from_numpy(idx)).numpy(),
        np.asarray(jtensor.take_along_rows(jnp.asarray(mat),
                                           jnp.asarray(idx))))


# --- ranking ------------------------------------------------------------------------

def _scores(seed=0, nq=6, nc=9, ties=True):
    rng = np.random.RandomState(seed)
    s = rng.randn(nq, nc).astype(np.float32)
    if ties:
        s = np.round(s, 0)   # many equal scores: the stable order decides
    return s, rng.randint(0, 3, nq), rng.randint(0, 3, nc)


@pytest.mark.parametrize("remove_top1", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_binary_ranking_and_metrics_equal_jax(remove_top1, ties):
    s, yq, yc = _scores(ties=ties)
    got = ranking.score_matrix_to_binary_ranking(
        torch.from_numpy(s), torch.from_numpy(yq), torch.from_numpy(yc),
        remove_top1)
    want = jranking.score_matrix_to_binary_ranking(
        jnp.asarray(s), jnp.asarray(yq), jnp.asarray(yc), remove_top1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in (1, 3):
        assert float(ranking.recall_at_k(got, k)) == pytest.approx(
            float(jranking.recall_at_k(want, k)), abs=1e-7)
    assert float(ranking.mean_average_precision(got)) == pytest.approx(
        float(jranking.mean_average_precision(want)), abs=1e-6)


@pytest.mark.parametrize("remove_top1", [False, True])
def test_rank_labels_equals_jax(remove_top1):
    s, yq, _ = _scores(nq=6, nc=6)
    labels, idx = ranking.rank_labels(torch.from_numpy(yq),
                                      torch.from_numpy(s), remove_top1)
    jl, ji = jranking.rank_labels(jnp.asarray(yq), jnp.asarray(s),
                                  remove_top1)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


# --- generic ----------------------------------------------------------------------

def test_set_random_seed_is_deterministic():
    g1 = generic.set_random_seed(7)
    a = (np.random.rand(), torch.rand(2), torch.rand(2, generator=g1))
    g2 = generic.set_random_seed(7)
    b = (np.random.rand(), torch.rand(2), torch.rand(2, generator=g2))
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2],
                                                                    b[2])
    assert os.environ["PYTHONHASHSEED"] == "7"


def test_deserialize_object_as_jax():
    registry = {"double": lambda x=2: 2 * x, "const": 3}
    for mod in (generic, jgeneric):
        assert mod.deserialize_object("double", registry, "fn", x=4) == 8
        assert mod.deserialize_object("const", {"const": 3}, "v") == 3
        with pytest.raises(ValueError, match="Unknown fn:nope"):
            mod.deserialize_object("nope", registry, "fn")
        with pytest.raises(ValueError, match="Could not interpret"):
            mod.deserialize_object(5, registry, "fn")


@pytest.mark.parametrize("name,dtype", [("bfloat16", torch.bfloat16),
                                        ("mixed_float16", torch.float16),
                                        ("float32", torch.float32)])
def test_use_mixed_precision(name, dtype, capsys):
    assert generic.use_mixed_precision(name) is dtype
    assert "Computation dtype: " + name in capsys.readouterr().out
    with pytest.raises(ValueError, match="Unknown precision"):
        generic.use_mixed_precision("int4")


def test_set_dtype_policy_deep_sets_every_layer():
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    vit = VisionTransformer(16, 32, 1, 2, 64, image_size=(32, 32),
                            classes=3, device="cpu").eval()
    out = generic.set_dtype_policy_deep(vit, "bfloat16")
    assert out is vit
    dtypes = {m.dtype for m in vit.modules() if "dtype" in vars(m)}
    assert dtypes == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in vit.parameters())
    x = torch.rand(2, 32, 32, 3)
    assert vit(x).dtype == torch.float32  # the head casts back
    with pytest.raises(ValueError, match="dtype"):
        generic.set_dtype_policy_deep(torch.nn.ReLU(), torch.bfloat16)


def test_timer_and_progress_bar_render_as_jax():
    with generic.Timer() as t:
        sum(range(1000))
    assert t.elapsed >= 0
    outs = []
    for mod in (generic, jgeneric):
        stream = io.StringIO()
        bar = mod.ProgressBar(total=4, cols=8, stream=stream)
        bar.add(1)
        bar.update(3)
        outs.append([line.split(" - ")[0] for line in
                     stream.getvalue().split("\r") if line])
    assert outs[0] == outs[1] == ["1/4 [==>.....]", "3/4 [======>.]"]
    # dataset_apply_fn: the port's Dataset, one step a yielded element
    outs = []
    for mod in (generic, jgeneric):
        stream = io.StringIO()
        bar = mod.ProgressBar(total=3, cols=6, stream=stream)
        ds = bar.dataset_apply_fn([1, 2, 3])
        assert type(ds).__module__.endswith("data.core")
        assert list(ds) == [1, 2, 3] and bar._steps == 3
        outs.append([line.split(" - ")[0] for line in
                     stream.getvalue().split("\r") if line])
    assert type(generic.ProgressBar(1).dataset_apply_fn([])).__module__ == (
        "chambers_tpu_torch.data.core")
    assert outs[0] == outs[1]


def test_model_memory_usage():
    net = torch.nn.Sequential(torch.nn.Linear(2048, 2048))
    params_only = generic.get_model_memory_usage(1, net)
    assert params_only == pytest.approx(round((2048 * 2048 + 2048) * 4
                                              / 1024 ** 3, 3))
    with_acts = generic.get_model_memory_usage(8, net, input_shape=(2048,))
    assert with_acts >= params_only
    assert generic.effective_cpu_count() >= 1


def test_utils_data_is_left_to_item_7():
    """Item 7 ported ``utils/data.py``: its four names exist and stream
    what the JAX package's do (``tests/test_torch_eval_utils.py`` holds
    them to JAX in full)."""
    from chambers_tpu.utils import data as jdata
    from chambers_tpu_torch.utils import data

    for name in ("valid_cardinality", "pair_iteration_dataset",
                 "reshape_pair_predictions", "batch_predict_pairs"):
        assert callable(getattr(data, name))
    q, c = np.arange(5)[:, None], np.arange(3)[:, None]
    got = list(data.pair_iteration_dataset(q, c, 2, 2))
    want = list(jdata.pair_iteration_dataset(q, c, 2, 2))
    assert len(got) == len(want) == 6
    for (a, b), (ja, jb) in zip(got, want):
        assert np.array_equal(a, ja) and np.array_equal(b, jb)


# --- profiling ----------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_and_annotate_names_a_range(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("my_range"):
            torch.ones(16).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert any(e.name == "my_range" for e in prof.events())


# --- msgpack ------------------------------------------------------------------------

_DTYPES = ["float32", "float64", "float16", "int8", "int32", "int64",
           "uint8", "bool"]


@pytest.mark.parametrize("dtype", _DTYPES)
def test_reads_flax_arrays_of_every_dtype(dtype):
    rng = np.random.RandomState(0)
    arr = (rng.randn(3, 5) * 10).astype(dtype)
    tree = {"a": {"x": arr, "scalar": np.float32(2.5), "empty": np.zeros(
        (0, 4), dtype)}, "n": 3}
    got = msgpack_io.loads(serialization.to_bytes(tree))
    np.testing.assert_array_equal(got["a"]["x"], arr)
    assert got["a"]["x"].dtype == arr.dtype
    assert got["a"]["scalar"] == np.float32(2.5)
    assert got["a"]["empty"].shape == (0, 4) and got["n"] == 3


def test_reads_bfloat16_as_exact_float32():
    values = np.random.RandomState(1).randn(7).astype(np.float32)
    tree = {"w": jnp.asarray(values, jnp.bfloat16)}
    got = msgpack_io.loads(serialization.to_bytes(tree))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(tree["w"], np.float32))


def test_writes_flax_bytes():
    rng = np.random.RandomState(2)
    tree = {"params": {"Dense_0": {"kernel": rng.randn(4, 3).astype(
        np.float32), "bias": np.zeros(3, np.float32)}},
        "batch_stats": {"BatchNorm_0": {"mean": rng.randn(3).astype(
            np.float32)}}}
    want = serialization.to_bytes(tree)
    assert msgpack_io.dumps(tree) == want
    # (jax.tree.map would sort the keys)
    as_tensors = {c: {m: {k: torch.from_numpy(v) for k, v in leaves.items()}
                      for m, leaves in mods.items()}
                  for c, mods in tree.items()}
    assert msgpack_io.dumps(as_tensors) == want


def test_written_bfloat16_tensors_read_back_in_flax():
    t = torch.randn(5, generator=torch.Generator().manual_seed(0)).bfloat16()
    back = serialization.msgpack_restore(msgpack_io.dumps({"w": t}))["w"]
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back, np.float32),
                                  t.float().numpy())


def test_scalars_strings_and_containers_round_trip():
    import msgpack

    obj = {"ints": [0, 127, 128, 255, 256, 65536, 2 ** 40, -1, -32, -33,
                    -200, -40000, -2 ** 40],
           "floats": [1.5, -0.0, 1e300], "flags": [True, False, None],
           "text": "x" * 40 + "ü", "blob": b"y" * 300,
           "deep": {str(i): i for i in range(20)}}
    packed = msgpack_io.dumps(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    assert msgpack_io.loads(packed) == obj


def test_chunked_flax_arrays_are_reassembled(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(100, dtype=np.float32).reshape(10, 10)
    got = msgpack_io.loads(serialization.msgpack_serialize({"big": arr}))
    np.testing.assert_array_equal(got["big"], arr)


def test_malformed_data_raises():
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.loads(b"\x92\x01")
    with pytest.raises(ValueError, match="trailing"):
        msgpack_io.loads(b"\x01\x02")
    with pytest.raises(TypeError, match="cannot write"):
        msgpack_io.dumps({"x": object()})


def test_import_h5_reads_a_jax_save_weights_file(tmp_path):
    """``weights=`` of a ``Model.save_weights`` msgpack: a JAX ViT's file
    loads into the port's preset, outputs within 1e-5."""
    from chambers_tpu.models.backbones import vision_transformer as jvit
    from chambers_tpu_torch.models.backbones import vision_transformer as tvit

    jmodel = jvit.ViTS16(input_shape=(32, 32, 3), classes=5, weights=None)
    path = str(tmp_path / "vit.msgpack")
    jmodel.save_weights(path)
    port = tvit.ViTS16(input_shape=(32, 32, 3), classes=5, weights=path,
                       dropout_rate=0.0, device="cpu")
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
