"""Native UDF compile service and dylib host, and UDF activation (the port's
copy of arroyo_tpu/compiler.py).

- ``CompileService`` builds a user's C++ UDF source into a shared library
  with g++ (-shared over one translation unit) and publishes the artifact,
  content-addressed, through ``state.storage`` (a local directory, s3:// or
  gs://), so every worker can fetch it; ``CompileServer`` runs it as its own
  HTTP service (the ``compile-service`` subcommand). A failed build raises
  with g++'s log. Artifacts default to ``arroyo_tpu_torch/build/
  udf-artifacts`` (``compiler.artifacts-url`` names another prefix).
- ``load_native_udf`` fetches the artifact on the worker (object stores into
  a content-keyed cache), dlopens it with ctypes and registers the symbol
  into the UDF registry the planner consults, as a vectorized batch call
  (one FFI hop per batch, not per row).
- ``activate_udf_specs`` registers persisted UDF records (a controller DB
  row, a worker's ``--udfs-file``): a ``cpp`` record loads its artifact, a
  ``python`` record executes its source, which calls ``register_udf`` /
  ``register_udaf`` of ``arroyo_tpu_torch.udf``.

C ABI contract (vectorized, columnar):

    extern "C" void NAME(int64_t n, const A0* a0, ..., R* out);

with A*/R drawn from {int64_t, double}. The host allocates ``out``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

_CTYPE = {
    "int64": ctypes.POINTER(ctypes.c_int64),
    "float64": ctypes.POINTER(ctypes.c_double),
}
_NPDTYPE = {"int64": np.int64, "float64": np.float64}
DEFAULT_ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                 "udf-artifacts")


class CompileError(RuntimeError):
    pass


@dataclass
class NativeUdfSpec:
    name: str
    arg_dtypes: tuple[str, ...]
    return_dtype: str
    artifact_url: str  # storage path of the built .so


class CompileService:
    """Builds C++ UDF sources into shared libraries and publishes them.

    artifacts_url: storage prefix (a local directory, s3:// or gs://) the
    built libraries are pushed to; workers fetch from the same prefix."""

    def __init__(self, artifacts_url: Optional[str] = None):
        from .config import config

        self.artifacts_url = (artifacts_url or config().get("compiler.artifacts-url")
                              or DEFAULT_ARTIFACTS)

    def build_udf(self, name: str, source: str, arg_dtypes: list[str],
                  return_dtype: str) -> NativeUdfSpec:
        """Compile ``source`` (a C++ translation unit defining the
        extern-C symbol ``name``) and publish the dylib. Idempotent per
        (name, source) — the artifact key is content-addressed."""
        from .state import storage

        for d in list(arg_dtypes) + [return_dtype]:
            if d not in _CTYPE:
                raise CompileError(f"unsupported UDF dtype {d!r} (int64/float64)")
        digest = hashlib.sha256(source.encode()).hexdigest()[:16]
        artifact = os.path.join(self.artifacts_url, f"{name}-{digest}.so")
        if not storage.exists(artifact):
            with tempfile.TemporaryDirectory(prefix="arroyo-udf-") as d:
                src = os.path.join(d, f"{name}.cc")
                out = os.path.join(d, f"{name}.so")
                with open(src, "w") as f:
                    f.write(source)
                r = subprocess.run(
                    ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o", out, src],
                    capture_output=True, text=True, timeout=120,
                )
                if r.returncode != 0:
                    raise CompileError(f"g++ failed for UDF {name!r}:\n{r.stderr}")
                with open(out, "rb") as f:
                    data = f.read()
            storage.makedirs(self.artifacts_url)
            storage.write_bytes(artifact, data)
        return NativeUdfSpec(name, tuple(arg_dtypes), return_dtype, artifact)


class CompileServer:
    """Standalone compile service, a JSON/HTTP daemon: POST /compile
    {name, source, arg_dtypes, return_dtype} ->
    {artifact_url}; GET /status. The API server delegates cpp UDF builds
    here when ``compiler.endpoint`` is configured, keeping g++ and
    untrusted source compilation off the control-plane process."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 artifacts_url: Optional[str] = None):
        import json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        svc = CompileService(artifacts_url)
        self.service = svc

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, payload) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/status":
                    self._json(200, {"ok": True,
                                     "artifacts_url": svc.artifacts_url})
                else:
                    self._json(404, {"error": "no route"})

            def do_POST(self):
                if self.path != "/compile":
                    self._json(404, {"error": "no route"})
                    return
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(n) or b"{}")
                    spec = svc.build_udf(
                        body["name"], body["source"],
                        list(body.get("arg_dtypes", [])),
                        body.get("return_dtype", "float64"))
                except (CompileError, KeyError, TypeError, ValueError) as e:
                    # bad JSON / bad shape / bad source: the submitter's fault
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 - g++ missing, timeout
                    # service-side failure: still answer, or the API wraps
                    # the dropped connection as "unreachable" and the real
                    # diagnostic is lost
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._json(200, {
                    "name": spec.name, "artifact_url": spec.artifact_url,
                    "arg_dtypes": list(spec.arg_dtypes),
                    "return_dtype": spec.return_dtype,
                })

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CompileServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name=f"compile-service-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


def compile_udf(name: str, source: str, arg_dtypes: list[str],
                return_dtype: str) -> NativeUdfSpec:
    """Build through the remote compile service when ``compiler.endpoint``
    is configured, else in-process."""
    from .config import config

    endpoint = config().get("compiler.endpoint")
    if not endpoint:
        return CompileService().build_udf(name, source, arg_dtypes, return_dtype)
    import json as _json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        str(endpoint).rstrip("/") + "/compile",
        data=_json.dumps({
            "name": name, "source": source, "arg_dtypes": arg_dtypes,
            "return_dtype": return_dtype}).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=180) as r:
            out = _json.loads(r.read())
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        try:
            detail = _json.loads(detail).get("error", detail)
        except ValueError:
            pass
        raise CompileError(detail) from e
    except urllib.error.URLError as e:
        raise CompileError(f"compile service unreachable: {e.reason}") from e
    return NativeUdfSpec(out["name"], tuple(out["arg_dtypes"]),
                         out["return_dtype"], out["artifact_url"])


# --------------------------------------------------------------- dylib host

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def _fetch_local(artifact_url: str) -> str:
    """Materialize the artifact on the local file system: an object store's
    (s3:// or gs://; the JAX package fetches s3:// only) into a
    content-keyed cache under the temporary directory; local paths pass
    through."""
    from .state import storage

    if not artifact_url.startswith(("s3://", "gs://")):
        return artifact_url[len("file://"):] if artifact_url.startswith("file://") else artifact_url
    cache = os.path.join(tempfile.gettempdir(), "arroyo-tpu-torch-udf-cache")
    os.makedirs(cache, exist_ok=True)
    local = os.path.join(cache, os.path.basename(artifact_url))
    if not os.path.exists(local):
        data = storage.read_bytes(artifact_url)
        tmp = f"{local}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, local)
    return local


def load_native_udf(spec: NativeUdfSpec) -> None:
    """dlopen the artifact and register the symbol as a vectorized SQL UDF
    (shares the planner-visible registry with Python UDFs)."""
    from .udf import register_udf

    path = _fetch_local(spec.artifact_url)
    with _load_lock:
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(path)
            _loaded[path] = lib
    fn = getattr(lib, spec.name)  # AttributeError = bad artifact, surfaced
    fn.argtypes = [ctypes.c_int64] + [_CTYPE[d] for d in spec.arg_dtypes] + [
        _CTYPE[spec.return_dtype]
    ]
    fn.restype = None
    arg_np = [_NPDTYPE[d] for d in spec.arg_dtypes]
    out_np = _NPDTYPE[spec.return_dtype]

    def call(*cols):
        n = len(cols[0]) if cols else 0
        ins = [np.ascontiguousarray(c, dtype=t) for c, t in zip(cols, arg_np)]
        out = np.empty(n, dtype=out_np)
        fn(n, *[c.ctypes.data_as(_CTYPE[d]) for c, d in zip(ins, spec.arg_dtypes)],
           out.ctypes.data_as(_CTYPE[spec.return_dtype]))
        return out

    register_udf(spec.name, call, return_dtype=spec.return_dtype, vectorized=True)


def activate_udf_specs(specs: list[dict]) -> None:
    """Register persisted UDF records (controller DB rows, a --udfs-file
    payload) into this process's planner-visible registry: a cpp record
    loads its built artifact, a python record executes its source, which
    calls register_udf / register_udaf."""
    for rec in specs:
        if rec["language"] == "cpp":
            load_native_udf(NativeUdfSpec(
                rec["name"], tuple(rec["arg_dtypes"]), rec["return_dtype"],
                rec["artifact_url"],
            ))
        elif rec["language"] == "python":
            exec(rec["source"], {})  # noqa: S102 - user-supplied UDF, by design
        else:
            raise CompileError(f"unknown UDF language {rec['language']!r}")
