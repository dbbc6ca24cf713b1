"""``chambers_tpu_torch.serving`` on the CPU against the JAX package's
``serving``: the same seeded models (JAX weights through
``state_dict_from_jax``) exported by both, and the served outputs compared
to 1e-5 (the tolerance of the JAX package's own serving tests); the
batcher's and the HTTP server's cases of ``tests/test_serving.py``; and a
flash ViT exported through the K3a operator."""

import glob
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from chambers_tpu import serving as jserving
from chambers_tpu.models import Model as JModel
from chambers_tpu.models.backbones.vision_transformer import (
    VisionTransformer as JViT,
)
from chambers_tpu_torch.layers.convolution import BatchNorm
from chambers_tpu_torch.models import Model
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.models.backbones.vision_transformer import (
    VisionTransformer,
)
from chambers_tpu_torch.quantization import QuantDense
from chambers_tpu_torch.serving import (
    BatchedServer,
    HTTPModelServer,
    export_serving_artifact,
    load_serving_artifact,
)
from test_torch_package import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(patch_size=8, patch_dim=32, n_encoder_layers=2, n_heads=2,
           ff_dim=64, dropout_rate=0.0, include_top=True, classes=7,
           pooling="cls")


def _vit_pair(**extra):
    jvit = JViT(**VIT, **extra)
    variables = jvit.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tvit = VisionTransformer(**VIT, image_size=(32, 32), device="cpu",
                             **extra)
    tvit.load_state_dict(state_dict_from_jax(jax.device_get(
        variables["params"])))
    return JModel(jvit, variables), Model(tvit.eval())


def _jax_served(model, tmp_path, x, **kw):
    path = str(tmp_path / "jax.stablehlo")
    jserving.export_serving_artifact(model, path, x.shape[1:], **kw)
    return np.asarray(jserving.load_serving_artifact(path)(x))


@pytest.fixture(scope="module")
def tiny_vit():
    return _vit_pair()


def test_export_fixed_batch_roundtrip(tiny_vit, tmp_path):
    jmodel, tmodel = tiny_vit
    path = str(tmp_path / "model.pt2")
    assert export_serving_artifact(tmodel, path, (32, 32, 3),
                                   batch_size=4) > 0
    serve = load_serving_artifact(path)
    x = np.random.RandomState(0).rand(4, 32, 32, 3).astype(np.float32)
    got = serve(x)
    assert got.shape == (4, 7) and serve.device == torch.device("cpu")
    # the port's artifact against the JAX package's, 1e-5
    want = _jax_served(jmodel, tmp_path, x, batch_size=4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # and bit for bit the eager module's
    with torch.no_grad():
        assert torch.equal(got, tmodel(torch.from_numpy(x)))


def test_export_symbolic_batch(tiny_vit, tmp_path):
    jmodel, tmodel = tiny_vit
    path = str(tmp_path / "model_poly.pt2")
    export_serving_artifact(tmodel, path, (32, 32, 3), batch_size=None)
    jpath = str(tmp_path / "jax_poly.stablehlo")
    jserving.export_serving_artifact(jmodel, jpath, (32, 32, 3))
    serve = load_serving_artifact(path)
    jserve = jserving.load_serving_artifact(jpath)
    for b in (1, 3, 8):
        x = np.random.RandomState(b).rand(b, 32, 32, 3).astype(np.float32)
        out = serve(torch.from_numpy(x))
        assert out.shape == (b, 7)
        np.testing.assert_allclose(out.numpy(), np.asarray(jserve(x)),
                                   atol=1e-5)


def test_platforms_name_the_export_device(tiny_vit, tmp_path):
    _, tmodel = tiny_vit
    path = str(tmp_path / "p.pt2")
    export_serving_artifact(tmodel, path, (32, 32, 3), batch_size=2,
                            platforms=("cpu",))
    with pytest.raises(ValueError, match="platforms"):
        export_serving_artifact(tmodel, path, (32, 32, 3), batch_size=2,
                                platforms=("tpu", "cpu"))
    with pytest.raises(ValueError, match="serves on cpu"):
        load_serving_artifact(path, device="cuda")


def test_artifact_is_self_contained(tiny_vit, tmp_path):
    """The artifact bakes the weights: a fresh interpreter that imports
    only torch and numpy reproduces the outputs from the file alone."""
    jmodel, tmodel = tiny_vit
    path = str(tmp_path / "model.pt2")
    export_serving_artifact(tmodel, path, (32, 32, 3))
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    xfile, outfile = str(tmp_path / "x.npy"), str(tmp_path / "out.npy")
    np.save(xfile, x)
    script = (
        "import sys, numpy as np, torch\n"
        f"program = torch.export.load({path!r}).module()\n"
        f"out = program(torch.from_numpy(np.load({xfile!r})))\n"
        "assert not [m for m in sys.modules if m.startswith('chambers')]\n"
        f"np.save({outfile!r}, out.detach().numpy())\n"
    )
    subprocess.run([sys.executable, "-c", script], check=True, cwd=tmp_path,
                   timeout=300)
    np.testing.assert_allclose(np.load(outfile),
                               _jax_served(jmodel, tmp_path, x,
                                           batch_size=2), atol=1e-5)


def test_experiment_callback_serving_export(tmp_path):
    """``ExperimentCallback(serving_input_shape=...)`` writes the artifact
    at train end from the live module; it serves what the JAX package's
    ``model.stablehlo`` serves after the same training."""
    import optax

    from chambers_tpu.callbacks import ExperimentCallback as JExperiment
    from chambers_tpu.training import Trainer as JTrainer
    from chambers_tpu_torch.callbacks import ExperimentCallback
    from chambers_tpu_torch.training import Trainer

    class JNet(nn.Module):
        @nn.compact
        def __call__(self, x, deterministic=True):
            return nn.Dense(1)(x)

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = QuantDense(4, 1, device="cpu")

        def forward(self, x, deterministic=None):
            return self.Dense_0(x)

    module = JNet()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    net = TNet()
    net.load_state_dict(state_dict_from_jax(jax.device_get(
        variables["params"])))
    rng = np.random.RandomState(3)
    data = [(rng.rand(8, 4).astype(np.float32),
             rng.rand(8, 1).astype(np.float32)) for _ in range(2)]
    jtrainer = JTrainer(JModel(module, variables),
                        loss=lambda a, b: jnp.mean((a - b) ** 2),
                        optimizer=optax.sgd(1e-2))
    jtrainer.fit(data, epochs=1, verbose=False,
                 callbacks=[JExperiment(str(tmp_path / "jax"),
                                        serving_input_shape=(4,))])
    trainer = Trainer(net, loss=lambda a, b: torch.mean((a - b) ** 2),
                      optimizer=lambda named: torch.optim.SGD(
                          [p for _, p in named], lr=1e-2))
    trainer.fit(data, epochs=1, verbose=False,
                callbacks=[ExperimentCallback(str(tmp_path / "torch"),
                                              serving_input_shape=(4,))])

    (jartifact,) = glob.glob(str(tmp_path / "jax" / "*" / "model" / "export"
                                 / "model.stablehlo"))
    (artifact,) = glob.glob(str(tmp_path / "torch" / "*" / "model" / "export"
                                / "model.pt2"))
    assert os.path.exists(os.path.join(os.path.dirname(artifact),
                                       "model.msgpack"))
    x = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    got = load_serving_artifact(artifact)(x).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jserving.load_serving_artifact(jartifact)(x)),
        atol=1e-5)
    with torch.no_grad():
        np.testing.assert_array_equal(got, net(torch.from_numpy(x)).numpy())


def test_export_batchnorm_model(tmp_path):
    """The running statistics ride along: the artifact reproduces the
    deterministic (running-average) forward."""

    class JBN(nn.Module):
        @nn.compact
        def __call__(self, x, deterministic=True):
            x = nn.Dense(8)(x)
            x = nn.BatchNorm(use_running_average=deterministic)(x)
            return nn.Dense(2)(x)

    class TBN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = QuantDense(4, 8, device="cpu")
            self.BatchNorm_0 = BatchNorm(8, device="cpu")
            self.Dense_1 = QuantDense(8, 2, device="cpu")

        def forward(self, x, deterministic=True):
            x = self.BatchNorm_0(self.Dense_0(x), train=not deterministic)
            return self.Dense_1(x)

    module = JBN()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    variables = jax.tree.map(lambda v: v + 0.25, variables)
    net = TBN()
    net.load_state_dict(state_dict_from_jax(
        jax.device_get(variables["params"]),
        batch_stats=jax.device_get(variables["batch_stats"])))
    path = str(tmp_path / "bn.pt2")
    export_serving_artifact(net, path, (4,), batch_size=3)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(
        load_serving_artifact(path)(x).numpy(),
        _jax_served(JModel(module, variables), tmp_path, x, batch_size=3),
        atol=1e-5)


def test_export_moe_model(tmp_path):
    """A top-2 routed ViT exports and reloads (the routing's cumsum and
    one-hot products trace at a fixed batch)."""
    jmodel, tmodel = _vit_pair(moe_every_n=2, moe_n_experts=4,
                               moe_n_selected_experts=2)
    path = str(tmp_path / "moe.pt2")
    export_serving_artifact(tmodel, path, (32, 32, 3), batch_size=4)
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    got = load_serving_artifact(path)(x).numpy()
    np.testing.assert_allclose(
        got, _jax_served(jmodel, tmp_path, x, batch_size=4),
        rtol=1e-5, atol=1e-5)


def test_flash_vit_exports_through_the_k3a_operator(tiny_vit, tmp_path):
    """``attention_impl="flash"``: the program calls
    ``chambers_tpu_torch::flash_fwd`` (its fake registration gave export
    the shapes) and no copy of the plain version; reloaded it equals the
    eager flash module and the dense one to float rounding. A bare
    interpreter cannot load it; one that imports the operator can."""
    _, dense = tiny_vit
    flash = VisionTransformer(**VIT, image_size=(32, 32), device="cpu",
                              attention_impl="flash").eval()
    flash.load_state_dict(dense.module.state_dict())
    path = str(tmp_path / "flash.pt2")
    export_serving_artifact(flash, path, (32, 32, 3))
    program = torch.export.load(path)
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert sum("chambers_tpu_torch.flash_fwd" in t for t in targets) == 1
    assert not any("softmax" in t or "amax" in t for t in targets)
    launches = [n for n in program.graph.nodes if n.op == "call_function"
                and "flash_fwd" in str(n.target)]
    assert len(launches) == VIT["n_encoder_layers"]
    serve = load_serving_artifact(path)
    for b in (1, 3):
        x = torch.from_numpy(np.random.RandomState(b).rand(
            b, 32, 32, 3).astype(np.float32))
        with torch.no_grad():
            want = flash(x)
            assert torch.equal(serve(x), want)
            np.testing.assert_allclose(want.numpy(), dense(x).numpy(),
                                       atol=1e-5)
    load = f"import torch\ntorch.export.load({path!r})\n"
    bare = subprocess.run([sys.executable, "-c", load], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert bare.returncode != 0 and "flash_fwd" in bare.stderr
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c",
                    "import chambers_tpu_torch.ops.flash_attention\n" + load],
                   cwd=tmp_path, env=env, check=True, timeout=300)


class TestBatchedServer:
    """Dynamic request batching over one fixed-batch forward."""

    def _serve_fn(self):
        calls = []

        def counting(x):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            calls.append(tuple(x.shape))
            return x * 2.0 + 1.0

        return counting, calls

    def test_full_batches_one_dispatch_each(self):
        fn, calls = self._serve_fn()
        xs = [np.full((3,), i, np.float32) for i in range(8)]
        with BatchedServer(fn, batch_size=4, max_delay_ms=200,
                           device="cpu") as server:
            outs = [f.result(timeout=30) for f in server.submit_many(xs)]
        for i, out in enumerate(outs):
            np.testing.assert_allclose(out, xs[i] * 2.0 + 1.0)
        assert server.stats == {"requests": 8, "batches": 2,
                                "padded_rows": 0}
        assert all(s == (4, 3) for s in calls)

    def test_partial_batch_flushes_after_max_delay(self):
        fn, calls = self._serve_fn()
        with BatchedServer(fn, batch_size=8, max_delay_ms=20,
                           device="cpu") as server:
            out = server.submit(np.ones((2,), np.float32)).result(timeout=30)
        np.testing.assert_allclose(out, [3.0, 3.0])
        assert server.stats["padded_rows"] == 7
        assert calls and calls[0] == (8, 2)  # padded to the fixed batch

    def test_concurrent_clients_get_their_own_rows(self):
        fn, _ = self._serve_fn()
        with BatchedServer(fn, batch_size=4, max_delay_ms=10,
                           device="cpu") as server:
            def client(i):
                x = np.full((5,), float(i), np.float32)
                return i, server.submit(x).result(timeout=30)

            with ThreadPoolExecutor(8) as pool:
                for i, out in pool.map(client, range(24)):
                    np.testing.assert_allclose(out,
                                               np.full((5,), 2.0 * i + 1.0))

    def test_fn_exception_propagates_to_futures(self):
        def broken(x):
            raise RuntimeError("device on fire")

        with BatchedServer(broken, batch_size=2, max_delay_ms=5,
                           device="cpu") as server:
            fut = server.submit(np.zeros((1,), np.float32))
            with pytest.raises(RuntimeError, match="device on fire"):
                fut.result(timeout=30)

    def test_closed_server_rejects_submissions(self):
        fn, _ = self._serve_fn()
        server = BatchedServer(fn, batch_size=2, device="cpu")
        server.close()
        server.close()  # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            server.submit(np.zeros((1,), np.float32))

    def test_cuda_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchedServer(lambda x: x, batch_size=2)

    def test_serves_loaded_artifact(self, tmp_path):
        """The full production path: export, load (no model code), serve
        padded; the row equals the JAX package's served row."""

        class JNet(nn.Module):
            @nn.compact
            def __call__(self, x, deterministic=True):
                return nn.Dense(3)(x)

        module = JNet()
        variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
        net = QuantDense(4, 3, device="cpu")
        net.load_state_dict(state_dict_from_jax(jax.device_get(
            variables["params"]["Dense_0"])))
        path = str(tmp_path / "m.pt2")
        export_serving_artifact(net, path, input_shape=(4,), batch_size=4)
        serve = load_serving_artifact(path)
        want = _jax_served(JModel(module, variables), tmp_path,
                           np.ones((4, 4), np.float32), batch_size=4)[0]
        with BatchedServer(serve, batch_size=4, max_delay_ms=10) as server:
            assert server.device == torch.device("cpu")
            out = server.submit(np.ones((4,), np.float32)).result(timeout=60)
        np.testing.assert_allclose(out, want, atol=1e-5)


def _post(port, path, body, content_type="application/json"):
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": content_type}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _http(fn, **kw):
    return HTTPModelServer(fn, port=0, device="cpu", **kw)


class TestHTTPModelServer:
    """TF-Serving's REST schema over the dynamic batcher."""

    def test_json_predict_matches_direct_call(self):
        w = torch.tensor([[2.0], [1.0]])
        fn = lambda x: x @ w
        x = np.asarray([[1.0, 2.0], [3.0, 4.0], [0.5, -1.0]], np.float32)
        with _http(fn, batch_size=4, dtype=np.float32) as server:
            status, body, ctype = _post(server.port,
                                        "/v1/models/anything:predict",
                                        {"instances": x.tolist()})
        assert status == 200 and ctype == "application/json"
        np.testing.assert_allclose(np.asarray(json.loads(body)["predictions"]),
                                   x @ w.numpy(), rtol=1e-6)

    def test_binary_npy_round_trip(self):
        x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, x)
        with _http(lambda t: t * 2.0, batch_size=8) as server:
            status, body, ctype = _post(
                server.port, "/predict", buf.getvalue(),
                content_type="application/octet-stream")
        assert status == 200 and ctype == "application/octet-stream"
        np.testing.assert_allclose(np.load(io.BytesIO(body)), x * 2.0,
                                   rtol=1e-6)

    def test_bfloat16_outputs_widen_to_float32(self):
        with _http(lambda t: t.to(torch.bfloat16), batch_size=2,
                   dtype=np.float32) as server:
            status, body, _ = _post(server.port, "/predict",
                                    {"instances": [[1.5, -2.0]]})
        assert status == 200
        assert json.loads(body)["predictions"] == [[1.5, -2.0]]

    def test_concurrent_clients_share_batches(self):
        with _http(lambda t: t + 1.0, batch_size=8, max_delay_ms=50,
                   dtype=np.float32) as server:
            def one(i):
                return _post(server.port, "/predict",
                             {"instances": [[float(i)]]})

            with ThreadPoolExecutor(8) as pool:
                results = list(pool.map(one, range(16)))
            for i, (status, body, _) in enumerate(results):
                assert status == 200
                assert json.loads(body)["predictions"] == [[i + 1.0]]
            stats = json.loads(_get(server.port, "/stats")[1])
        assert stats["requests"] == 16
        assert stats["batches"] < 16  # dynamic batching actually batched
        assert stats["latency_ms_p50"] <= stats["latency_ms_p99"]
        assert stats["latency_ms_max"] > 0

    def test_health_stats_and_errors(self):
        def failing(x):
            if bool((x < 0).any()):
                raise RuntimeError("negative input")
            return x

        with _http(failing, batch_size=2) as server:
            status, body, _ = _get(server.port, "/healthz")
            assert status == 200 and json.loads(body) == {"status": "ok"}
            assert _get(server.port, "/nope")[0] == 404
            assert _post(server.port, "/predict", b"{not json",
                         "application/json")[0] == 400
            assert _post(server.port, "/predict",
                         {"instances": []})[0] == 400
            assert _post(server.port, "/other", {"a": 1})[0] == 404
            status, body, _ = _post(server.port, "/predict",
                                    {"instances": [[-1.0]]})
            assert status == 500 and "negative" in json.loads(body)["error"]

    def test_stop_releases_port(self):
        server = _http(lambda x: x, batch_size=2).start()
        port = server.port
        server.stop()
        s = socket.socket()
        s.bind(("127.0.0.1", port))  # free again
        s.close()

    def test_stop_before_start_and_double_stop(self):
        server = _http(lambda x: x, batch_size=2)
        server.stop()
        server.stop()


class TestBatchedServerRobustness:
    def test_malformed_request_fails_its_future_not_the_server(self):
        with BatchedServer(lambda x: x * 2.0, batch_size=2, max_delay_ms=20,
                           device="cpu") as server:
            bad = server.submit_many(
                [np.zeros(3, np.float32), np.zeros(5, np.float32)])
            with pytest.raises(Exception):
                bad[0].result(timeout=10)
            with pytest.raises(Exception):
                bad[1].result(timeout=10)
            good = server.submit(np.asarray([1.0, 2.0], np.float32))
            np.testing.assert_allclose(good.result(timeout=10), [2.0, 4.0])

    def test_close_fails_stragglers_instead_of_hanging(self):
        server = BatchedServer(lambda x: x, batch_size=4, max_delay_ms=1,
                               device="cpu")
        server.close()
        # the submit that raced past the _closed check: enqueue directly,
        # then drain through a second close()
        fut = Future()
        server._queue.put((np.zeros(2, np.float32), fut))
        server._closed = False
        server.close()
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=10)


def test_latency_stats_nearest_rank():
    """Percentiles are nearest rank, ceil(q·n) - 1."""
    server = BatchedServer(lambda x: x, batch_size=1, device="cpu")
    try:
        server._latencies.extend([0.001, 0.100])
        stats = server.latency_stats()
        assert stats["latency_ms_p50"] == pytest.approx(1.0)
        assert stats["latency_ms_max"] == pytest.approx(100.0)
        server._latencies.clear()
        server._latencies.extend([i / 1000 for i in range(1, 101)])
        stats = server.latency_stats()
        assert stats["latency_ms_p50"] == pytest.approx(50.0)
        assert stats["latency_ms_p90"] == pytest.approx(90.0)
        assert stats["latency_ms_p99"] == pytest.approx(99.0)  # not max
        assert stats["latency_ms_max"] == pytest.approx(100.0)
    finally:
        server.close()


class TestServingUnderLoad:
    def test_sixteen_plus_concurrent_http_clients(self):
        """24 clients × 4 sequential multi-instance requests, all in flight
        together: every row right, counters exact, percentiles ordered."""
        w = torch.tensor([[2.0], [-1.0]])
        n_clients, n_reqs, n_inst = 24, 4, 3

        def client(cid):
            ok = []
            for r in range(n_reqs):
                x = [[float(cid), float(r + k)] for k in range(n_inst)]
                status, body, _ = _post(port, "/v1/models/m:predict",
                                        {"instances": x})
                assert status == 200
                ok.append(json.loads(body)["predictions"]
                          == [[2.0 * cid - (r + k)] for k in range(n_inst)])
            return all(ok)

        with _http(lambda x: x @ w, batch_size=8, max_delay_ms=5,
                   dtype=np.float32) as server:
            port = server.port
            with ThreadPoolExecutor(n_clients) as pool:
                assert all(pool.map(client, range(n_clients)))
            stats = json.loads(_get(port, "/stats")[1])
        assert stats["requests"] == n_clients * n_reqs * n_inst
        assert 0 < stats["batches"] <= stats["requests"]
        assert (0 < stats["latency_ms_p50"] <= stats["latency_ms_p90"]
                <= stats["latency_ms_p99"] <= stats["latency_ms_max"])

    def test_clean_shutdown_with_inflight_requests(self):
        """stop() while 16 clients have requests in flight: every client
        gets a definitive outcome and stop() returns promptly."""

        def slow_fn(x):
            time.sleep(0.05)
            return x * 2.0

        server = _http(slow_fn, batch_size=4, max_delay_ms=2,
                       dtype=np.float32).start()
        port = server.port
        outcomes = []

        def client(cid):
            try:
                status, body, _ = _post(port, "/predict",
                                        {"instances": [[float(cid)]]})
                assert json.loads(body)["predictions"] == [[2.0 * cid]]
                outcomes.append("ok")
            except (urllib.error.URLError, ConnectionError, OSError):
                outcomes.append("refused")

        with ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(client, i) for i in range(16)]
            time.sleep(0.08)
            stopper = threading.Thread(target=server.stop)
            stopper.start()
            for f in futs:
                f.result(timeout=60)
            stopper.join(timeout=30)
        assert not stopper.is_alive(), "stop() hung with in-flight requests"
        assert len(outcomes) == 16 and "ok" in outcomes
        s = socket.socket()
        s.settimeout(2)
        with pytest.raises(OSError):
            s.connect(("127.0.0.1", port))
        s.close()
