"""URL-dispatched storage behind checkpoints, compile artifacts and file
connectors (the port's copy of arroyo_tpu/state/storage.py).

One path-string API: ``/abs/path`` or ``file:///abs/path`` for a local file
system, ``s3://`` and ``gs://`` for object stores. Every write is an
atomic publish (a temporary file, then ``os.replace``) and returns the
integrity envelope ``{crc, len, algo}`` of the bytes it wrote; readers verify
an envelope with ``verify_envelope``. The algorithm is the JAX package's:
hardware crc32c when the ``crc32c`` module is importable, else zlib's crc32,
and its name rides in every envelope, so either package verifies the
other's files.

Every read, write, listing and delete runs behind the shared retry layer
(utils/retry.py, ``storage.retry.*``) and one circuit breaker, with its
fault point (``storage.get`` / ``put`` / ``list`` / ``delete``) inside the
retried call, so an injected transient fault recovers in place. Puts and
gets also honour ``corrupt=bitflip|truncate``: the bytes in flight are
damaged after the envelope was taken, as a truncated upload or bit rot
would be.

Object stores: ``s3://bucket/prefix`` (boto3 where it is installed, else a
client injected with ``set_s3_client``; none raises) and ``gs://bucket/prefix``
(``GcsHttpClient``, the JSON API over urllib, or one injected with
``set_gcs_client``). Directory-shaped operations (listdir, isdir, rmtree) are
delimiter listings of key prefixes. S3 puts above
``storage.multipart-threshold-bytes`` go through the multipart API with
abort on error, each part behind the ``storage.multipart`` fault point.
"""

from __future__ import annotations

import logging
import os
import shutil
import struct
import threading
import time
import zlib
from typing import Callable, Optional

from ..faults import fault_point
from ..utils.retry import CircuitBreaker, RetryPolicy, default_transient, retry_call

_log = logging.getLogger("arroyo_tpu_torch.storage")

_s3_client = None
_gcs_client = None


class IntegrityError(RuntimeError):
    """A state artifact's bytes do not match its recorded checksum envelope
    (a truncated upload, bit rot, a torn write). Restore paths catch it to
    quarantine the epoch and fall back; it is never retried."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"integrity check failed for {path}: {reason}")
        self.path = path
        self.reason = reason


_crc_fn = None
_crc_algo = None


def _crc_impl():
    """(crc function, algo name): crc32c when a library provides it, else
    zlib.crc32. The name is recorded in every envelope so a reader
    recomputes with the writer's algorithm."""
    global _crc_fn, _crc_algo
    if _crc_fn is None:
        try:
            from crc32c import crc32c as _c  # type: ignore

            _crc_fn, _crc_algo = _c, "crc32c"
        except ImportError:
            _crc_fn, _crc_algo = zlib.crc32, "crc32"
    return _crc_fn, _crc_algo


def checksum_of(data: bytes) -> dict:
    """Integrity envelope of one artifact: {crc, len, algo}."""
    fn, algo = _crc_impl()
    return {"crc": fn(data) & 0xFFFFFFFF, "len": len(data), "algo": algo}


def verify_envelope(data: bytes, env: dict, path: str) -> None:
    """Raise IntegrityError unless ``data`` matches the recorded envelope.
    An envelope of an algorithm this host cannot compute degrades to the
    length check, with a warning."""
    want_len = env.get("len")
    if want_len is not None and len(data) != int(want_len):
        raise IntegrityError(path, f"length {len(data)} != recorded {want_len}")
    algo = env.get("algo")
    fn, have = _crc_impl()
    if algo not in (None, have):
        if algo == "crc32":
            fn = zlib.crc32
        else:
            _log.warning("cannot verify %s: recorded algo %r unavailable "
                         "(length check only)", path, algo)
            return
    if "crc" in env and (fn(data) & 0xFFFFFFFF) != int(env["crc"]):
        raise IntegrityError(path, f"{algo or have} mismatch (recorded {env['crc']})")


# Self-describing trailer for artifacts that outlive the epoch whose
# manifest would carry their envelope: payload + [crc u32][len u64]
# [algo 8s][magic 8s], the magic last so the tail alone detects it.
FOOTER_MAGIC = b"ARROYOCK"
_FOOTER_LEN = 4 + 8 + 8 + 8


def wrap_footer(data: bytes) -> bytes:
    env = checksum_of(data)
    return (data + struct.pack(">IQ", env["crc"], env["len"])
            + env["algo"].encode().ljust(8) + FOOTER_MAGIC)


def unwrap_footer(data: bytes, path: str = "<buffer>", verify: bool = True) -> bytes:
    """Strip (and optionally verify) the integrity footer; data without one
    passes through untouched."""
    if len(data) < _FOOTER_LEN or not data.endswith(FOOTER_MAGIC):
        return data
    trailer = data[-_FOOTER_LEN:]
    crc, length = struct.unpack(">IQ", trailer[:12])
    algo = trailer[12:20].strip().decode("ascii", "replace")
    payload = data[:-_FOOTER_LEN]
    if verify:
        verify_envelope(payload, {"crc": crc, "len": length, "algo": algo}, path)
    return payload


def _apply_corruption(data: bytes, mode: str) -> bytes:
    """Deterministic injected corruption (``storage.*:corrupt=<mode>``):
    bitflip flips one bit of the middle byte; truncate keeps the first
    half. Both are caught by any crc + length envelope."""
    if not data:
        return data
    if mode == "truncate":
        return data[:len(data) // 2]
    mid = len(data) // 2
    return data[:mid] + bytes([data[mid] ^ 0x01]) + data[mid + 1:]


# One breaker across every storage operation: when the store is hard-down,
# checkpoint attempts fail fast instead of each burning a full retry
# schedule.
_breaker = CircuitBreaker(threshold=8, cooldown_s=5.0, name="storage")
MULTIPART_DEFAULT = 8 * 1024 * 1024


def _policy() -> RetryPolicy:
    return RetryPolicy.from_config("storage.retry")


def reset_retry_state() -> None:
    """Close the storage circuit (tests isolate retry state per test)."""
    _breaker.reset()


def _guarded(site: str, key: str, fn: Callable):
    """Run one storage operation behind the shared retry layer, with the
    fault point inside the retried callable so an injected transient fault
    recovers in place (no job restart)."""

    def _once():
        fault_point(site, key=key)
        return fn()

    return retry_call(_once, policy=_policy(), retry_on=default_transient,
                      description=f"{site} {key}", breaker=_breaker)


def _guarded_v(site: str, key: str, fn: Callable):
    """Like _guarded, but the callable receives the fault point's verdict:
    the data paths (get, put) apply a ``corrupt`` verdict to the bytes in
    flight."""

    def _once():
        return fn(fault_point(site, key=key))

    return retry_call(_once, policy=_policy(), retry_on=default_transient,
                      description=f"{site} {key}", breaker=_breaker)


def set_s3_client(client) -> None:
    """Inject an S3 client (tests: an in-memory fake; production may pass a
    configured boto3 client to control credentials/endpoints)."""
    global _s3_client
    _s3_client = client


def set_gcs_client(client) -> None:
    """Inject a GCS client with the GcsHttpClient surface (download/upload/
    list/delete/exists); tests pass an in-memory fake."""
    global _gcs_client
    _gcs_client = client


def _get_s3():
    global _s3_client
    if _s3_client is None:
        try:
            import boto3  # type: ignore

            _s3_client = boto3.client("s3")
        except ImportError as e:
            raise RuntimeError(
                "s3:// storage requires boto3 (not installed) or an injected "
                "client via arroyo_tpu_torch.state.storage.set_s3_client"
            ) from e
    return _s3_client


def _get_gcs():
    global _gcs_client
    if _gcs_client is None:
        _gcs_client = GcsHttpClient()
    return _gcs_client


class GcsHttpClient:
    """Minimal GCS JSON-API client over urllib (reference GCS backend,
    arroyo-storage lib.rs:192). Auth: bearer token from
    GOOGLE_OAUTH_ACCESS_TOKEN or the GCE metadata server; anonymous
    otherwise (public buckets / emulators). Endpoint overridable for
    fake-gcs-server style emulators via STORAGE_EMULATOR_HOST."""

    # refresh this many seconds before the token's stated expiry
    TOKEN_REFRESH_MARGIN_S = 120.0

    def __init__(self, endpoint: Optional[str] = None, timeout: float = 20.0):
        self.endpoint = (endpoint or os.environ.get("STORAGE_EMULATOR_HOST")
                         or "https://storage.googleapis.com").rstrip("/")
        self.timeout = timeout
        self._token: Optional[str] = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        self._token_source = "env" if self._token else None
        self._token_expiry: Optional[float] = None  # monotonic deadline
        self._probed_metadata = False

    def _token_stale(self) -> bool:
        return (self._token_expiry is not None
                and time.monotonic() >= self._token_expiry - self.TOKEN_REFRESH_MARGIN_S)  # lint: waive LR109 — GCS token expiry deadline, not self-measurement

    def _headers(self) -> dict:
        if self._token is None and not self._probed_metadata:
            # probe the metadata server ONCE; off-GCE hosts must not pay a
            # 2s timeout per storage operation
            self._probed_metadata = True
            self._metadata_token()
        elif self._token_source == "metadata" and self._token_stale():
            # GCE access tokens expire (~1h): proactively re-fetch near
            # expiry so long-running checkpoint streams never see the 401
            self._metadata_token()
        return {"Authorization": f"Bearer {self._token}"} if self._token else {}

    def _metadata_token(self) -> Optional[str]:
        import json as _json
        import urllib.request

        try:
            req = urllib.request.Request(
                "http://metadata.google.internal/computeMetadata/v1/instance/"
                "service-accounts/default/token",
                headers={"Metadata-Flavor": "Google"})
            with urllib.request.urlopen(req, timeout=2) as r:
                payload = _json.loads(r.read())
                self._token = payload["access_token"]
                self._token_source = "metadata"
                expires_in = payload.get("expires_in")
                self._token_expiry = (
                    time.monotonic() + float(expires_in) if expires_in else None)  # lint: waive LR109 — GCS token expiry deadline, not self-measurement
                return self._token
        except Exception:  # noqa: BLE001 - not on GCE
            return None

    def _refresh_token(self) -> bool:
        """Force-refresh after an auth failure: re-read the env var (it may
        have been rotated in place) and re-probe the metadata server even if
        an earlier probe failed. True if a (possibly new) token is held."""
        before = self._token
        env = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        if env and env != self._token:
            self._token = env
            self._token_source = "env"
            self._token_expiry = None
            return True
        self._probed_metadata = True
        self._metadata_token()
        return self._token is not None and self._token != before

    def _call(self, method: str, url: str, data: Optional[bytes] = None,
              content_type: Optional[str] = None) -> bytes:
        # transient (5xx/429/network) retries belong to the shared layer
        # wrapping the public storage ops (_guarded) — retrying here too
        # would compound the schedules into attempts^2 during an outage.
        # This layer only owns the auth lifecycle: refresh-once on 401/403.
        import urllib.error

        def _once() -> bytes:
            import urllib.request

            headers = self._headers()
            if content_type:
                headers["Content-Type"] = content_type
            req = urllib.request.Request(url, data=data, method=method,
                                         headers=headers)
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()

        try:
            return _once()
        except urllib.error.HTTPError as e:
            if e.code in (401, 403) and self._refresh_token():
                # expired/rotated credentials: retry exactly once with the
                # fresh token; a second auth failure is a real config error
                return _once()
            raise

    @staticmethod
    def _q(name: str) -> str:
        import urllib.parse

        return urllib.parse.quote(name, safe="")

    def download(self, bucket: str, name: str) -> bytes:
        return self._call(
            "GET", f"{self.endpoint}/storage/v1/b/{bucket}/o/{self._q(name)}?alt=media")

    def upload(self, bucket: str, name: str, data: bytes) -> None:
        self._call(
            "POST",
            f"{self.endpoint}/upload/storage/v1/b/{bucket}/o"
            f"?uploadType=media&name={self._q(name)}",
            data=data, content_type="application/octet-stream")

    def delete(self, bucket: str, name: str) -> None:
        self._call(
            "DELETE", f"{self.endpoint}/storage/v1/b/{bucket}/o/{self._q(name)}")

    def exists(self, bucket: str, name: str) -> bool:
        import urllib.error

        try:
            self._call(
                "GET", f"{self.endpoint}/storage/v1/b/{bucket}/o/{self._q(name)}")
            return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    def list(self, bucket: str, prefix: str,
             delimiter: Optional[str] = None) -> tuple[list[str], list[str]]:
        """(object names, sub-prefixes) under prefix, paginated."""
        import json as _json

        names: list[str] = []
        prefixes: list[str] = []
        token: Optional[str] = None
        while True:
            url = (f"{self.endpoint}/storage/v1/b/{bucket}/o"
                   f"?prefix={self._q(prefix)}")
            if delimiter:
                url += f"&delimiter={self._q(delimiter)}"
            if token:
                url += f"&pageToken={token}"
            resp = _json.loads(self._call("GET", url) or b"{}")
            names.extend(i["name"] for i in resp.get("items", []))
            prefixes.extend(resp.get("prefixes", []))
            token = resp.get("nextPageToken")
            if not token:
                return names, prefixes


def _parse_s3(path: str) -> Optional[tuple[str, str]]:
    if not path.startswith("s3://"):
        return None
    rest = path[len("s3://"):]
    bucket, _, key = rest.partition("/")
    return bucket, key.rstrip("/")


def _parse_gcs(path: str) -> Optional[tuple[str, str]]:
    if not path.startswith("gs://"):
        return None
    rest = path[len("gs://"):]
    bucket, _, key = rest.partition("/")
    return bucket, key.rstrip("/")


def _local(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


# ------------------------------------------------------------------ bytes


def read_bytes(path: str) -> bytes:
    def _do(verdict) -> bytes:
        s3 = _parse_s3(path)
        if s3:
            data = _get_s3().get_object(Bucket=s3[0], Key=s3[1])["Body"].read()
        else:
            gcs = _parse_gcs(path)
            if gcs:
                data = _get_gcs().download(gcs[0], gcs[1])
            else:
                with open(_local(path), "rb") as f:
                    data = f.read()
        if verdict and verdict[0] == "corrupt":
            data = _apply_corruption(data, str(verdict[1]))
        return data

    return _guarded_v("storage.get", path, _do)


def _multipart_threshold() -> int:
    from ..config import config

    v = config().get("storage.multipart-threshold-bytes")
    return int(v) if v is not None else MULTIPART_DEFAULT


S3_MIN_PART = 5 * 1024 * 1024  # AWS: every non-final part must be >= 5 MiB


def _multipart_part_size() -> int:
    from ..config import config

    v = config().get("storage.multipart-part-size-bytes")
    if v is not None:
        return int(v)
    # part size decoupled from the trigger threshold: a small threshold
    # must not produce parts real S3 rejects with EntityTooSmall
    return max(_multipart_threshold(), S3_MIN_PART)


def _s3_multipart_put(client, bucket: str, key: str, data: bytes,
                      part_size: int) -> None:
    """Multipart upload with abort-on-error (reference lib.rs:317
    start/add/close multipart path)."""
    up = client.create_multipart_upload(Bucket=bucket, Key=key)
    upload_id = up["UploadId"]
    try:
        parts = []
        num = 1
        for off in range(0, len(data), part_size):
            fault_point("storage.multipart", key=key, part=num)
            r = client.upload_part(
                Bucket=bucket, Key=key, UploadId=upload_id, PartNumber=num,
                Body=data[off:off + part_size])
            parts.append({"PartNumber": num, "ETag": r["ETag"]})
            num += 1
        client.complete_multipart_upload(
            Bucket=bucket, Key=key, UploadId=upload_id,
            MultipartUpload={"Parts": parts})
    except Exception:
        # never leave a half-finished upload accruing storage charges
        try:
            client.abort_multipart_upload(
                Bucket=bucket, Key=key, UploadId=upload_id)
        except Exception as e2:  # noqa: BLE001
            _log.warning("abort_multipart_upload(%s) failed: %s", key, e2)
        raise


def write_bytes(path: str, data: bytes) -> dict:
    """Write one artifact atomically; returns the integrity envelope of the
    true bytes, taken before any injected corruption (so a corrupt put is
    caught on read, as a truncated upload is). A local file's temporary
    file is the writer's own, so two writers of one path (jobs of one id in
    two processes) cannot tear each other's write; an object-store put is
    atomic by the service's semantics, and one above
    ``storage.multipart-threshold-bytes`` (8 MiB) goes through the multipart
    API, aborted on error."""
    env = checksum_of(data)

    def _do(verdict) -> None:
        payload = data
        if verdict and verdict[0] == "corrupt":
            payload = _apply_corruption(payload, str(verdict[1]))
        s3 = _parse_s3(path)
        if s3:
            client = _get_s3()
            threshold = _multipart_threshold()
            if (len(payload) > threshold
                    and hasattr(client, "create_multipart_upload")):
                _s3_multipart_put(client, s3[0], s3[1], payload,
                                  _multipart_part_size())
            else:
                client.put_object(Bucket=s3[0], Key=s3[1], Body=payload)
            return
        gcs = _parse_gcs(path)
        if gcs:
            _get_gcs().upload(gcs[0], gcs[1], payload)
            return
        p = _local(path)
        tmp = f"{p}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, p)

    _guarded_v("storage.put", path, _do)
    return env


def read_text(path: str) -> str:
    return read_bytes(path).decode("utf-8")


def write_text(path: str, text: str) -> dict:
    return write_bytes(path, text.encode("utf-8"))


def verify_mode() -> str:
    """``state.integrity.verify``: ``restore`` (default — verify artifacts
    on the restore path only), ``always`` (every checkpointed read), or
    ``off`` (trust the store; fsck still verifies explicitly)."""
    from ..config import config

    return str(config().get("state.integrity.verify") or "restore")


# -------------------------------------------------------------- directory


def makedirs(path: str) -> None:
    if _parse_s3(path) or _parse_gcs(path):
        return  # prefixes need no creation
    os.makedirs(_local(path), exist_ok=True)


def _is_not_found(exc: Exception) -> bool:
    """True only for a definitive not-found; transient S3 failures
    (throttling, auth) must propagate — mapping them to "absent" would make
    a committed checkpoint look incomplete and restore an older epoch."""
    if isinstance(exc, (KeyError, FileNotFoundError)):
        return True  # injected fake clients
    resp = getattr(exc, "response", None)
    if isinstance(resp, dict):
        code = str(resp.get("Error", {}).get("Code", ""))
        status = resp.get("ResponseMetadata", {}).get("HTTPStatusCode")
        return code in ("404", "NoSuchKey", "NotFound") or status == 404
    return False


def exists(path: str) -> bool:
    s3 = _parse_s3(path)
    if s3:
        try:
            _get_s3().head_object(Bucket=s3[0], Key=s3[1])
            return True
        except Exception as e:
            if _is_not_found(e):
                return False
            raise
    gcs = _parse_gcs(path)
    if gcs:
        return _get_gcs().exists(gcs[0], gcs[1])
    return os.path.exists(_local(path))


def isdir(path: str) -> bool:
    def _do() -> bool:
        s3 = _parse_s3(path)
        if s3:
            bucket, key = s3
            resp = _get_s3().list_objects_v2(
                Bucket=bucket, Prefix=key + "/", MaxKeys=1)
            return resp.get("KeyCount", len(resp.get("Contents", []))) > 0
        gcs = _parse_gcs(path)
        if gcs:
            names, prefixes = _get_gcs().list(gcs[0], gcs[1] + "/")
            return bool(names or prefixes)
        return os.path.isdir(_local(path))

    return _guarded("storage.list", path, _do)


def listdir(path: str) -> list[str]:
    """Immediate children (files and sub-prefixes), names only."""
    return _guarded("storage.list", path, lambda: _listdir_once(path))


def _listdir_once(path: str) -> list[str]:
    s3 = _parse_s3(path)
    if s3:
        bucket, key = s3
        prefix = key + "/" if key else ""
        names = set()
        token = None
        while True:
            kwargs = dict(Bucket=bucket, Prefix=prefix, Delimiter="/")
            if token:
                kwargs["ContinuationToken"] = token
            resp = _get_s3().list_objects_v2(**kwargs)
            for c in resp.get("Contents", []):
                names.add(c["Key"][len(prefix):])
            for p in resp.get("CommonPrefixes", []):
                names.add(p["Prefix"][len(prefix):].rstrip("/"))
            token = resp.get("NextContinuationToken")
            if not token:
                break
        return sorted(n for n in names if n)
    gcs = _parse_gcs(path)
    if gcs:
        bucket, key = gcs
        prefix = key + "/" if key else ""
        onames, oprefixes = _get_gcs().list(bucket, prefix, delimiter="/")
        out = {n[len(prefix):] for n in onames}
        out.update(p[len(prefix):].rstrip("/") for p in oprefixes)
        return sorted(n for n in out if n)
    return sorted(os.listdir(_local(path)))


def remove(path: str) -> None:
    def _do() -> None:
        s3 = _parse_s3(path)
        if s3:
            _get_s3().delete_object(Bucket=s3[0], Key=s3[1])
            return
        gcs = _parse_gcs(path)
        if gcs:
            _get_gcs().delete(gcs[0], gcs[1])
            return
        os.remove(_local(path))

    _guarded("storage.delete", path, _do)


def rmtree(path: str) -> None:
    """Best-effort recursive delete (GC path — mirrors the local branch's
    ignore_errors; a transient S3 failure must not crash the engine over a
    cleanup step). S3 keys go through batched delete_objects (1000/request)
    when the client supports it."""
    s3 = _parse_s3(path)
    if s3:
        bucket, key = s3
        client = _get_s3()
        token = None
        errors = 0
        while True:
            try:
                kwargs = dict(Bucket=bucket, Prefix=key + "/")
                if token:
                    kwargs["ContinuationToken"] = token
                resp = client.list_objects_v2(**kwargs)
            except Exception as e:  # noqa: BLE001
                # without a continuation token we cannot advance; stop, but
                # leave a trail so checkpoint-GC leaks are visible
                _log.warning("rmtree(%s): list failed, sweep aborted: %s", path, e)
                return
            keys = [c["Key"] for c in resp.get("Contents", [])]
            batched = keys and hasattr(client, "delete_objects")
            for chunk in ([keys[i:i + 1000] for i in range(0, len(keys), 1000)]
                          if batched else [[k] for k in keys]):
                try:
                    if batched:
                        client.delete_objects(
                            Bucket=bucket,
                            Delete={"Objects": [{"Key": k} for k in chunk]})
                    else:
                        client.delete_object(Bucket=bucket, Key=chunk[0])
                except Exception as e:  # noqa: BLE001
                    # keep sweeping the remaining batches — one transient
                    # failure must not abandon the whole prefix
                    errors += 1
                    if errors <= 3:
                        _log.warning("rmtree(%s): delete batch failed: %s", path, e)
            token = resp.get("NextContinuationToken")
            if not token:
                break
        if errors:
            _log.warning("rmtree(%s): %d delete batch(es) failed", path, errors)
        return
    gcs = _parse_gcs(path)
    if gcs:
        bucket, key = gcs
        client = _get_gcs()
        try:
            names, _prefixes = client.list(bucket, key + "/")
        except Exception as e:  # noqa: BLE001
            _log.warning("rmtree(%s): list failed, sweep aborted: %s", path, e)
            return
        errors = 0
        for n in names:
            try:
                client.delete(bucket, n)
            except Exception as e:  # noqa: BLE001
                errors += 1
                if errors <= 3:
                    _log.warning("rmtree(%s): delete %s failed: %s", path, n, e)
        if errors:
            _log.warning("rmtree(%s): %d delete(s) failed", path, errors)
        return
    shutil.rmtree(_local(path), ignore_errors=True)
