"""Confluent schema-registry resolver (the port's copy of
arroyo_tpu/formats/schema_registry.py).

Reference: arroyo-rpc/src/schema_resolver.rs (ConfluentSchemaRegistry —
fetch/register subject schemas over the REST API). HTTP client uses urllib;
an in-memory registry backs tests and air-gapped runs.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Optional


class SchemaRegistryError(RuntimeError):
    pass


class ConfluentSchemaRegistry:
    """Minimal client for the Confluent REST API (subjects/ids endpoints)."""

    def __init__(self, endpoint: str, api_key: Optional[str] = None,
                 api_secret: Optional[str] = None, timeout: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        self._auth = None
        if api_key:
            import base64

            token = base64.b64encode(f"{api_key}:{api_secret or ''}".encode()).decode()
            self._auth = f"Basic {token}"
        self._by_id: dict[int, str] = {}

    def _get(self, path: str) -> dict:
        req = urllib.request.Request(self.endpoint + path)
        if self._auth:
            req.add_header("Authorization", self._auth)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except Exception as e:  # noqa: BLE001
            raise SchemaRegistryError(f"schema registry GET {path} failed: {e}") from e

    def get_schema_by_id(self, schema_id: int) -> str:
        if schema_id not in self._by_id:
            self._by_id[schema_id] = self._get(f"/schemas/ids/{schema_id}")["schema"]
        return self._by_id[schema_id]

    def get_latest(self, subject: str) -> tuple[int, str]:
        d = self._get(f"/subjects/{subject}/versions/latest")
        return int(d["id"]), d["schema"]

    def register(self, subject: str, schema: str) -> int:
        body = json.dumps({"schema": schema}).encode()
        req = urllib.request.Request(
            f"{self.endpoint}/subjects/{subject}/versions", data=body, method="POST",
            headers={"Content-Type": "application/vnd.schemaregistry.v1+json"},
        )
        if self._auth:
            req.add_header("Authorization", self._auth)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return int(json.loads(resp.read())["id"])
        except Exception as e:  # noqa: BLE001
            raise SchemaRegistryError(f"schema registry register failed: {e}") from e


class InMemorySchemaRegistry:
    """Test/air-gapped stand-in with the same surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._schemas: dict[int, str] = {}
        self._subjects: dict[str, list[int]] = {}
        self._next = 1

    def register(self, subject: str, schema: str) -> int:
        with self._lock:
            for sid, s in self._schemas.items():
                if s == schema:
                    self._subjects.setdefault(subject, []).append(sid)
                    return sid
            sid = self._next
            self._next += 1
            self._schemas[sid] = schema
            self._subjects.setdefault(subject, []).append(sid)
            return sid

    def get_schema_by_id(self, schema_id: int) -> str:
        with self._lock:
            if schema_id not in self._schemas:
                raise SchemaRegistryError(f"no schema with id {schema_id}")
            return self._schemas[schema_id]

    def get_latest(self, subject: str) -> tuple[int, str]:
        with self._lock:
            ids = self._subjects.get(subject)
            if not ids:
                raise SchemaRegistryError(f"no subject {subject}")
            return ids[-1], self._schemas[ids[-1]]
