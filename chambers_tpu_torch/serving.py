"""Ahead-of-time export for serving, and the batched servers (port of
``chambers_tpu/serving.py``).

The artifact is a ``torch.export`` program: the eval-mode forward
(``deterministic=True``) traced to an ATen graph with the weights baked in,
written as one ``.pt2`` file by ``torch.export.save``. A server reloads it
with :func:`load_serving_artifact` (``torch.export.load``) and needs no
model code: a fresh interpreter that imports only ``torch`` and ``numpy``
reproduces the outputs. The one exception is a model on the flash kernels:
its program calls the operator ``chambers_tpu_torch::flash_fwd`` (K3a,
``ops/flash_attention.py``), which must be registered before the load, so
``chambers_tpu_torch.ops.flash_attention`` is imported first.

Differences from the JAX artifact: the program's constants live on the
device of the export (JAX lowers StableHLO for any ``platforms``), so the
artifact serves where it was exported; and the file holds a ``torch.export``
program, not StableHLO.

:class:`BatchedServer` is the dynamic batcher (one dispatcher thread packs
single requests into zero-padded ``batch_size`` batches) and
:class:`HTTPModelServer` TF-Serving's REST predict contract over it, both
with the JAX package's semantics. Results come back to the host as numpy;
bfloat16 outputs widen to float32 there (numpy has no bfloat16).
"""

from __future__ import annotations

import collections
import io
import itertools
import json
import math
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from chambers_tpu_torch._device import resolve_device


class _ServingForward(nn.Module):
    """The forward a server calls: the model's inference path, always
    deterministic."""

    def __init__(self, model):
        super().__init__()
        self.module = getattr(model, "module", model)
        self._apply = getattr(model, "apply_fn", None)

    def forward(self, x):
        if self._apply is not None:
            return self._apply(x, deterministic=True)
        from chambers_tpu_torch.training.trainer import _accepts

        if _accepts(self.module.forward, "deterministic"):
            return self.module(x, deterministic=True)
        return self.module(x)


def _device_of(module):
    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return torch.device("cpu")


def export_serving_artifact(model, path: str, input_shape: Sequence[int],
                            batch_size: Optional[int] = None,
                            input_dtype=torch.float32,
                            platforms: Optional[Sequence[str]] = None):
    """Write ``model``'s eval-mode forward, weights baked in, to ``path``.

    :param model: a :class:`chambers_tpu_torch.models.Model` (its
        ``apply_fn``), or an ``nn.Module``.
    :param input_shape: per-example shape, e.g. ``(224, 224, 3)``.
    :param batch_size: fixed batch size; ``None`` exports a dynamic batch
        dimension (``torch.export.Dim``), so the artifact serves any batch.
        The trace runs on a sample batch of 2 then, since ``torch.export``
        fixes a dimension it sees at size 1.
    :param platforms: JAX lowers for the platforms named here;
        ``torch.export`` has no counterpart, the program's constants live on
        the device of the export. ``None`` or that device's type (``"cuda"``,
        ``"cpu"``) is accepted; anything else raises.
    :returns: the number of bytes written.
    """
    forward = _ServingForward(model)
    device = _device_of(forward.module)
    if platforms is not None and set(platforms) != {device.type}:
        raise ValueError(
            f"platforms={tuple(platforms)!r}: a torch.export program serves "
            f"on the device it was exported on ({device.type!r}); export the "
            "model on the target device instead")
    sample = torch.zeros((batch_size or 2, *input_shape), dtype=input_dtype,
                         device=device)
    dynamic = None
    if batch_size is None:
        dynamic = ({0: torch.export.Dim("batch", min=1)},)
    was_training = forward.module.training
    forward.module.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(forward, (sample,),
                                          dynamic_shapes=dynamic)
    finally:
        forward.module.train(was_training)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_serving_artifact(path: str, device=None):
    """Load an exported artifact; returns ``fn(images) -> outputs``.

    ``fn`` takes a tensor or a numpy array, moves it to the artifact's
    device and runs the program under ``torch.inference_mode``; the output
    is a tensor there. ``fn.device`` names that device. ``device``, when
    given, must be the artifact's (its constants are baked there)."""
    module = torch.export.load(path).module()
    home = _device_of(module)
    if device is not None and torch.device(device) != home:
        raise ValueError(f"the artifact serves on {home}, not {device}; "
                         "export it on the target device")

    def fn(x):
        x = torch.as_tensor(x).to(home)
        with torch.inference_mode():
            return module(x)

    fn.device = home
    fn.module = module
    return fn


def _host(out):
    """A batch's outputs (a tensor or a tuple/list/dict of them) as numpy,
    bfloat16 widened to float32."""
    if isinstance(out, (tuple, list)):
        return type(out)(_host(o) for o in out)
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()
    return np.asarray(out)


def _row(out, i):
    if isinstance(out, (tuple, list)):
        return type(out)(_row(o, i) for o in out)
    if isinstance(out, dict):
        return {k: _row(v, i) for k, v in out.items()}
    return out[i]


class BatchedServer:
    """Dynamic request batching over a fixed-batch forward.

    Requests enqueue single examples; one dispatcher thread packs up to
    ``batch_size`` of them (waiting at most ``max_delay_ms`` once it holds
    one), zero-pads the free slots of a partial batch, calls ``fn`` ONCE
    per packed batch with a tensor on ``device``, and resolves each
    request's future with its own output row (numpy, on the host). Padded
    rows are computed and discarded.

    ``fn`` is any ``[batch_size, ...] -> [batch_size, ...]`` callable — a
    model's forward or a :func:`load_serving_artifact` result (whose
    ``device`` the server uses when ``device`` is None; otherwise the
    default is CUDA, or the CPU when the caller asks for it).

    Threading contract: ``submit`` is safe from any number of client
    threads; only the dispatcher thread touches the device.

    Example::

        serve = load_serving_artifact("model.pt2")
        with BatchedServer(serve, batch_size=8, max_delay_ms=5) as server:
            logits = server.submit(image).result()   # [num_classes]
    """

    def __init__(self, fn, batch_size: int, max_delay_ms: float = 2.0,
                 device=None):
        if batch_size < 1:
            raise ValueError(f"batch_size={batch_size} must be >= 1")
        self.fn = fn
        self.batch_size = int(batch_size)
        self.max_delay = float(max_delay_ms) / 1e3
        self.device = resolve_device(
            device if device is not None else getattr(fn, "device", None))
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0}
        # enqueue->resolve latency of the most recent requests (seconds)
        self._latencies = collections.deque(maxlen=1024)
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="BatchedServer", daemon=True)
        self._thread.start()

    def submit(self, example):
        """Enqueue one example (the per-example shape ``fn`` expects after
        the batch dimension); returns a ``concurrent.futures.Future``
        resolving to that example's output row."""
        if self._closed:
            raise RuntimeError("BatchedServer is closed")
        fut: Future = Future()
        self._queue.put((example, fut, time.monotonic()))
        # close() may have raced past its drain between our check and put;
        # if the dispatcher is already gone, nothing will ever serve this
        if self._closed and not self._thread.is_alive() and not fut.done():
            try:
                fut.set_exception(RuntimeError("BatchedServer is closed"))
            except Exception:  # close()'s drain resolved it first
                pass
        return fut

    def submit_many(self, examples):
        return [self.submit(e) for e in examples]

    def _dispatch_loop(self):
        while True:
            item = self._queue.get()  # blocks; None = shutdown sentinel
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_delay
            while len(batch) < self.batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_batch(batch)
                    return
                batch.append(nxt)
            self._run_batch(batch)

    def _run_batch(self, batch):
        n = len(batch)
        try:
            # assembly is inside the try: a malformed example must fail
            # THESE futures, not kill the dispatcher and strand later ones
            x = np.stack([np.asarray(e) for e, _, _ in batch])
            if n < self.batch_size:
                pad = np.zeros((self.batch_size - n,) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad])
            out = _host(self.fn(torch.from_numpy(x).to(self.device)))
        except Exception as exc:  # resolve every waiter, never deadlock
            for _, fut, _ in batch:
                fut.set_exception(exc)
            return
        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["padded_rows"] += self.batch_size - n
        done = time.monotonic()
        for i, (_, fut, t0) in enumerate(batch):
            self._latencies.append(done - t0)
            fut.set_result(_row(out, i))

    def latency_stats(self) -> dict:
        """p50/p90/p99/max enqueue→resolve latency (ms) over the most
        recent requests (bounded window)."""
        lat = sorted(self._latencies)
        if not lat:
            return {}
        # nearest rank, ceil(q·n) - 1: int(q·n) would bias every quantile
        # one rank high (p50 of 2 samples = the max)
        pick = lambda q: lat[min(max(math.ceil(q * len(lat)) - 1, 0),
                                 len(lat) - 1)] * 1e3
        return {"latency_ms_p50": pick(0.50), "latency_ms_p90": pick(0.90),
                "latency_ms_p99": pick(0.99), "latency_ms_max": lat[-1] * 1e3}

    def close(self):
        """Drain: stop accepting requests, finish queued ones, join."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join()
        # a submit() that passed the _closed check concurrently with this
        # close() may have enqueued behind the sentinel: fail it rather
        # than leave its result() blocked forever
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1].set_exception(RuntimeError("BatchedServer is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HTTPModelServer:
    """TF-Serving REST-compatible HTTP front over :class:`BatchedServer`,
    on the standard library's ``http.server``.

    Endpoints:

    - ``POST /v1/models/<anything>:predict`` (or ``/predict``): JSON
      ``{"instances": [...]}``, one example each (nested lists), answered
      ``{"predictions": [...]}`` row per instance; with ``Content-Type:
      application/octet-stream`` the body is a ``.npy`` batch and the
      answer a ``.npy`` of the outputs.
    - ``GET /stats``: the batching counters and latency percentiles.
    - ``GET /healthz``: liveness.

    A body that does not parse is a 400, as are no instances; an unknown
    route a 404; a failing forward a 500. ``dtype`` is the numpy type JSON
    instances are read as. ``device`` as :class:`BatchedServer`'s.

    Example::

        with HTTPModelServer(serve_fn, batch_size=8, port=8501) as server:
            ...   # serves on a background thread until the block ends
    """

    def __init__(self, fn, batch_size: int, port: int = 8501,
                 host: str = "127.0.0.1", max_delay_ms: float = 2.0,
                 dtype=None, device=None):
        import http.server

        self._batched = BatchedServer(fn, batch_size=batch_size,
                                      max_delay_ms=max_delay_ms,
                                      device=device)
        self._dtype = dtype
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no per-request lines
                pass

            def _reply(self, code, body: bytes, content_type):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code, obj):
                self._reply(code, json.dumps(obj).encode("utf-8"),
                            "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply_json(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._reply_json(200, {
                        **outer._batched.stats,
                        **outer._batched.latency_stats(),
                    })
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if not (self.path.endswith(":predict")
                        or self.path == "/predict"):
                    self._reply_json(404, {"error": f"no route {self.path}"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                binary = self.headers.get(
                    "Content-Type", "").startswith("application/octet-stream")
                try:
                    if binary:
                        batch = np.load(io.BytesIO(body), allow_pickle=False)
                        instances = list(batch)
                    else:
                        payload = json.loads(body)
                        instances = [np.asarray(i, dtype=outer._dtype)
                                     for i in payload["instances"]]
                except Exception as exc:
                    self._reply_json(400, {"error": f"bad request: {exc}"})
                    return
                if not instances:
                    self._reply_json(400, {"error": "empty instances"})
                    return
                try:
                    futures = outer._batched.submit_many(instances)
                    rows = [f.result() for f in futures]
                except Exception as exc:
                    self._reply_json(500, {"error": str(exc)})
                    return
                if binary:
                    buf = io.BytesIO()
                    np.save(buf, np.stack([np.asarray(r) for r in rows]))
                    self._reply(200, buf.getvalue(),
                                "application/octet-stream")
                else:
                    self._reply_json(200, {"predictions": [
                        np.asarray(r).tolist() for r in rows]})

        class Server(http.server.ThreadingHTTPServer):
            # socketserver's default backlog of 5 resets a burst of
            # simultaneous connects before accept() runs
            request_queue_size = 128

        self._http = Server((host, port), Handler)
        self._thread = None

    @property
    def port(self) -> int:
        """Bound port (useful with ``port=0`` for an ephemeral one)."""
        return self._http.server_address[1]

    @property
    def stats(self) -> dict:
        """The batcher's counters (what ``GET /stats`` reports)."""
        return dict(self._batched.stats)

    def start(self):
        self._thread = threading.Thread(
            target=self._http.serve_forever, name="HTTPModelServer",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop accepting, finish in-flight batches, release the port.
        Safe before :meth:`start` and twice."""
        if self._thread is not None:
            self._http.shutdown()
            self._thread.join()
            self._thread = None
        self._http.server_close()
        self._batched.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
