"""HTTP model server over exported serving artifacts.

Parity with the JAX CLI ``multimodalbrainsurvival_tpu/cli/serve.py``: every
artifact directory written by ``cli/export_model.py`` becomes a
JSON-over-HTTP scoring endpoint, on the stdlib's ``http.server`` and numpy,
with the same contract:

- ``GET /healthz``: liveness and each model's kind, quantization and
  request count;
- ``GET /v1/models``: every loaded artifact's ``meta.json``;
- ``POST /v1/models/<name>/score``: a JSON object whose keys are the
  artifact's calling-convention arguments, each a nested list or a
  ``{"b64", "shape", "dtype"}`` object (raw little-endian bytes); returns
  the program's outputs as lists, or as b64 objects with ``"encoding":
  "b64"``, and ``latency_ms``. A malformed request gets a 400 naming what
  is wrong; a model error a 500.

``--buckets 1,8,32`` pads each request's batch up to the next bucket (rows
copied from the last real row, outputs sliced back), so a mix of request
sizes meets a bounded set of shapes; ``--warmup 1`` calls each model once
at the smallest bucket before listening. The programs run on ``--device``
(``cuda`` by default, which raises without a card); an artifact exported
for another device is refused at startup.

    python -m multimodalbrainsurvival_torch.cli.serve --artifact mil=exports/mil \\
        --port 0 --buckets 1,8 --device cpu
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from multimodalbrainsurvival_torch.artifact import load_artifact
from multimodalbrainsurvival_torch.device import resolve_device

MAX_BODY_BYTES = 1 << 30


def parse_convention(meta: dict) -> list:
    """``meta["calling_convention"]["args"]`` strings (``"patch_bag uint8
    (b, g, 224, 224, 3)"``) → ``[(name, dtype, dims)]``, a dim an int where
    fixed, None where symbolic."""
    args = []
    for spec in meta["calling_convention"]["args"]:
        m = re.match(r"(\w+)\s+(\w+)\s+\(([^)]*)\)", spec)
        if not m:
            raise ValueError(f"unparseable calling-convention arg: {spec!r}")
        name, dtype, dims_s = m.groups()
        dims = [int(d) if d.strip().isdigit() else None for d in dims_s.split(",")]
        args.append((name, np.dtype(dtype), dims))
    return args


class BadRequest(Exception):
    pass


def dims_str(dims: list) -> str:
    return "(" + ", ".join("?" if d is None else str(d) for d in dims) + ")"


def next_bucket(b: int, buckets: list) -> int:
    for cap in buckets:
        if b <= cap:
            return cap
    return b  # beyond the largest bucket: served at its own size


class ServedModel:
    """One loaded artifact, its parsed calling convention and a lock (one
    call at a time on the device)."""

    def __init__(self, name: str, path: str, device: torch.device):
        self.name = name
        self.path = path
        self.device = device
        self.serving = load_artifact(path)
        self.meta = self.serving.meta
        platforms = self.meta.get("platforms", [])
        if device.type not in platforms:
            raise SystemExit(f"{path} was exported for {'+'.join(platforms) or '?'}, and this "
                             f"server runs on {device.type}: export it with --device "
                             f"{device.type}")
        self.args = parse_convention(self.meta)
        self.lock = threading.Lock()
        self.n_requests = 0

    def decode_arg(self, body: dict, name: str, dtype: np.dtype, dims: list) -> np.ndarray:
        if name not in body:
            raise BadRequest(f"missing argument {name!r} (expects {[a[0] for a in self.args]})")
        spec = body[name]
        if isinstance(spec, dict):
            try:
                raw = base64.b64decode(spec["b64"], validate=True)
                arr = np.frombuffer(raw, dtype=np.dtype(spec["dtype"])).reshape(spec["shape"])
            except (KeyError, ValueError, TypeError) as err:
                raise BadRequest(f"{name}: bad b64 array object ({err})")
        else:
            try:
                arr = np.asarray(spec)
            except (ValueError, TypeError) as err:
                raise BadRequest(f"{name}: not an array ({err})")
        if arr.ndim != len(dims):
            raise BadRequest(f"{name}: expected {len(dims)} dims {dims_str(dims)}, "
                             f"got shape {arr.shape}")
        for ax, d in enumerate(dims):
            if d is not None and arr.shape[ax] != d:
                raise BadRequest(f"{name}: dim {ax} must be {d} (got {arr.shape[ax]})")
        # JSON numbers arrive as int64 / float64: integers may feed an
        # integer or float argument, floats only a float one
        if not (arr.dtype == dtype or (arr.dtype.kind in "iu" and dtype.kind in "iuf")
                or (arr.dtype.kind == "f" and dtype.kind == "f")):
            raise BadRequest(f"{name}: dtype {arr.dtype} does not cast to {dtype}")
        if arr.dtype.kind in "iu" and dtype.kind in "iu" and arr.size and (
                arr.min() < np.iinfo(dtype).min or arr.max() > np.iinfo(dtype).max):
            raise BadRequest(f"{name}: values out of range for {dtype}")
        return np.ascontiguousarray(arr, dtype=dtype)

    def run(self, arrays: list) -> dict:
        """The program on numpy inputs (already padded) → numpy outputs."""
        tensors = [torch.from_numpy(np.require(a, requirements='W')).to(self.device)
                   for a in arrays]
        with self.lock:
            out = self.serving.call(*tensors)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            self.n_requests += 1
        return out

    def call(self, body: dict, buckets: list) -> dict:
        arrays = [self.decode_arg(body, n, dt, dims) for n, dt, dims in self.args]
        batches = {a.shape[0] for a in arrays}
        if len(batches) != 1:
            got = {spec[0]: arr.shape[0] for spec, arr in zip(self.args, arrays)}
            raise BadRequest(f"inconsistent batch dims: {got}")
        (b,) = batches
        if b == 0:
            raise BadRequest("empty batch")
        padded = next_bucket(b, buckets)
        if padded > b:
            arrays = [np.concatenate([a, np.repeat(a[-1:], padded - b, axis=0)], axis=0)
                      for a in arrays]
        return {k: v[:b] for k, v in self.run(arrays).items()}


def encode_outputs(out: dict, encoding: str) -> dict:
    if encoding == "b64":
        return {k: {"b64": base64.b64encode(np.ascontiguousarray(v).tobytes()).decode("ascii"),
                    "shape": list(v.shape), "dtype": str(v.dtype)}
                for k, v in out.items()}
    return {k: np.asarray(v).tolist() for k, v in out.items()}


class Handler(BaseHTTPRequestHandler):
    # set by build_server
    models: dict = {}
    buckets: list = []
    quiet: bool = False

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if not self.quiet:
            print(f"serve: {self.address_string()} {fmt % args}")

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server's name)
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "models": {n: {"kind": m.meta.get("kind"),
                               "quantize": m.meta.get("quantize", ""),
                               "requests": m.n_requests}
                           for n, m in self.models.items()},
            })
        elif self.path == "/v1/models":
            self._send_json(200, {n: m.meta for n, m in self.models.items()})
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        m = re.match(r"^/v1/models/([\w.-]+)/score$", self.path)
        if not m:
            self._send_json(404, {"error": f"unknown path {self.path} "
                                  "(POST /v1/models/<name>/score)"})
            return
        model = self.models.get(m.group(1))
        if model is None:
            self._send_json(404, {"error": f"unknown model {m.group(1)!r} "
                                  f"(loaded: {sorted(self.models)})"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > MAX_BODY_BYTES:
                raise BadRequest(f"Content-Length {length} out of range")
            body = json.loads(self.rfile.read(length))
            if not isinstance(body, dict):
                raise BadRequest("body must be a JSON object")
            t0 = time.monotonic()
            out = model.call(body, self.buckets)
            ms = (time.monotonic() - t0) * 1e3
            payload = encode_outputs(out, body.get("encoding", "json"))
            payload["latency_ms"] = round(ms, 3)
            self._send_json(200, payload)
        except BadRequest as err:
            self._send_json(400, {"error": str(err)})
        except json.JSONDecodeError as err:
            self._send_json(400, {"error": f"bad JSON body: {err}"})
        except Exception as err:  # the server outlives any model error
            self._send_json(500, {"error": f"{type(err).__name__}: {err}"})


def warmup(model: ServedModel, buckets: list) -> None:
    """One call at the smallest bucket (batch) and a bag of 1; masks and
    float arguments are ones, so no position looks padded."""
    b = buckets[0] if buckets else 1
    arrays = []
    for name, dtype, dims in model.args:
        shape = [b if ax == 0 else (d if d is not None else 1) for ax, d in enumerate(dims)]
        fill = np.ones if ("mask" in name or dtype.kind == "f") else np.zeros
        arrays.append(fill(shape, dtype=dtype))
    model.run(arrays)


def build_server(argv=None) -> ThreadingHTTPServer:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", action="append", required=True, metavar="[NAME=]DIR",
                   help="artifact directory from export_model; repeatable; NAME defaults "
                        "to the directory's base name")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = a free port (printed at startup)")
    p.add_argument("--buckets", default="",
                   help="comma-separated batch buckets (e.g. 1,8,32)")
    p.add_argument("--warmup", type=int, default=1,
                   help="1 = call each model once at the smallest bucket before serving")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--quiet", type=int, default=0)
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    models = {}
    for spec in a.artifact:
        name, _, path = spec.rpartition("=")
        if not name:
            name = os.path.basename(os.path.normpath(path))
        if name in models:
            raise SystemExit(f"duplicate model name {name!r}")
        models[name] = ServedModel(name, path, device)
        meta = models[name].meta
        print(f"serve: loaded {name!r} [{meta.get('kind')}] from {path} "
              f"({meta.get('size_bytes', 0) / 1e6:.1f} MB, "
              f"quantize={meta.get('quantize') or 'none'})")
    buckets = sorted({int(x) for x in a.buckets.split(",") if x})
    if any(b <= 0 for b in buckets):
        raise SystemExit("--buckets must be positive")
    handler = type("BoundHandler", (Handler,), {
        "models": models, "buckets": buckets, "quiet": bool(a.quiet)})
    server = ThreadingHTTPServer((a.host, a.port), handler)
    if a.warmup:
        for m in models.values():
            t0 = time.monotonic()
            warmup(m, buckets)
            print(f"serve: warmed up {m.name!r} in {time.monotonic() - t0:.1f}s")
    print(f"serve: listening on http://{server.server_address[0]}:{server.server_address[1]} "
          f"(models: {sorted(models)}, buckets: {buckets or 'exact'})")
    return server


def main(argv=None):
    server = build_server(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("serve: shutting down")
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
