"""Typed Python client for the REST API.

The port's copy of arroyo_tpu/api/client.py.

Equivalent of crates/arroyo-openapi (the client generated from the API's
OpenAPI spec and used by the integration tests, integ/tests/api_tests.rs).
One method per spec operationId; test_openapi.py asserts full coverage of
the spec so the client cannot drift from the server.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from typing import Any, Optional


class ApiError(RuntimeError):
    def __init__(self, status: int, payload: Any):
        super().__init__(f"HTTP {status}: {payload}")
        self.status = status
        self.payload = payload


class ArroyoClient:
    """client = ArroyoClient("http://localhost:5115")"""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 auth_token: Optional[str] = None):
        from ..config import config

        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # explicit token, else the cluster config's (api.auth-token)
        self.auth_token = auth_token or config().get("api.auth-token")

    # ------------------------------------------------------------- plumbing

    def _req(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method, headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except Exception:
                payload = e.reason
            raise ApiError(e.code, payload) from None

    # ----------------------------------------------------------- operations

    def ping(self) -> dict:
        return self._req("GET", "/api/v1/ping")

    def validate_query(self, query: str) -> dict:
        return self._req("POST", "/api/v1/pipelines/validate", {"query": query})

    def create_pipeline(self, query: str, name: str = "pipeline",
                        parallelism: int = 1,
                        tenant: Optional[str] = None) -> dict:
        body = {"name": name, "query": query, "parallelism": parallelism}
        if tenant is not None:
            # keys the fleet's per-tenant admission queues and quotas
            body["tenant"] = tenant
        return self._req("POST", "/api/v1/pipelines", body)

    def list_pipelines(self) -> list[dict]:
        return self._req("GET", "/api/v1/pipelines")["data"]

    def get_pipeline(self, pipeline_id: str) -> dict:
        return self._req("GET", f"/api/v1/pipelines/{pipeline_id}")

    def delete_pipeline(self, pipeline_id: str) -> dict:
        return self._req("DELETE", f"/api/v1/pipelines/{pipeline_id}")

    def pipeline_jobs(self, pipeline_id: str) -> list[dict]:
        return self._req("GET", f"/api/v1/pipelines/{pipeline_id}/jobs")["data"]

    def pipeline_graph(self, pipeline_id: str) -> dict:
        """Planned dataflow DAG: {nodes: [...], edges: [...]}."""
        return self._req("GET", f"/api/v1/pipelines/{pipeline_id}/graph")

    def evolve_pipeline(self, pipeline_id: str, query: str) -> dict:
        """Live evolution (versioned redeploy): plan-diff the evolved SQL
        against the running plan.  Compatible changes drain the job behind a
        final checkpoint, carry proven state, and cut over blue/green; an
        incompatible change raises ApiError(400) with AR-series diagnostics
        and never touches the job."""
        return self._req("POST", f"/api/v1/pipelines/{pipeline_id}/evolve",
                         {"query": query})

    def list_jobs(self) -> list[dict]:
        return self._req("GET", "/api/v1/jobs")["data"]

    def get_job(self, job_id: str) -> dict:
        return self._req("GET", f"/api/v1/jobs/{job_id}")

    def patch_job(self, job_id: str, stop: Optional[str] = None,
                  parallelism: Optional[int] = None) -> dict:
        body: dict = {}
        if stop is not None:
            body["stop"] = stop
        if parallelism is not None:
            body["parallelism"] = parallelism
        return self._req("PATCH", f"/api/v1/jobs/{job_id}", body)

    def job_checkpoints(self, job_id: str) -> dict:
        return self._req("GET", f"/api/v1/jobs/{job_id}/checkpoints")

    def job_output(self, job_id: str) -> dict:
        return self._req("GET", f"/api/v1/jobs/{job_id}/output")

    def job_metrics(self, job_id: str) -> dict:
        return self._req("GET", f"/api/v1/jobs/{job_id}/metrics")

    def job_profile(self, job_id: str) -> dict:
        """Runtime cost profile: per-operator busy%, self-time, state
        rows/bytes, hot keys (what `arroyo_tpu_torch explain` renders)."""
        return self._req("GET", f"/api/v1/jobs/{job_id}/profile")

    def job_traces(self, job_id: str, epoch: "Optional[int]" = None,
                   raw_events: bool = False) -> dict:
        """Checkpoint epoch traces: Chrome trace-event JSON by default,
        or the raw span events with raw_events=True."""
        q = []
        if epoch is not None:
            q.append(f"epoch={epoch}")
        if raw_events:
            q.append("format=events")
        suffix = f"?{'&'.join(q)}" if q else ""
        return self._req("GET", f"/api/v1/jobs/{job_id}/traces{suffix}")

    def job_events(self, job_id: str, level: Optional[str] = None,
                   since: Optional[float] = None,
                   after: Optional[int] = None) -> dict:
        """Structured job event feed (operator panics, restores, wedged
        epochs, health transitions); ``after`` is the seq cursor for
        incremental tailing."""
        q = []
        if level is not None:
            q.append(f"level={level}")
        if since is not None:
            q.append(f"since={since}")
        if after is not None:
            q.append(f"after={after}")
        suffix = f"?{'&'.join(q)}" if q else ""
        return self._req("GET", f"/api/v1/jobs/{job_id}/events{suffix}")

    def job_health(self, job_id: str) -> dict:
        """Job health (ok/degraded/critical) with per-rule observed value,
        threshold, and firing flag, plus the elastic autoscaler's rail
        state and last decision under the ``autoscaler`` key."""
        return self._req("GET", f"/api/v1/jobs/{job_id}/health")

    def job_fsck(self, job_id: str,
                 storage_url: "Optional[str]" = None) -> dict:
        """Offline checkpoint-chain verification: FS-series diagnostics
        over every epoch's artifacts; ``clean`` is False iff any ERROR
        finding (same predicate as the `fsck` CLI's exit code)."""
        suffix = ""
        if storage_url:
            from urllib.parse import quote

            suffix = f"?storage_url={quote(storage_url, safe='')}"
        return self._req("GET", f"/api/v1/jobs/{job_id}/fsck{suffix}")

    def fleet_status(self) -> dict:
        """Multi-tenant fleet snapshot: pool occupancy, per-tenant usage,
        and the admission queue with positions."""
        return self._req("GET", "/api/v1/fleet")

    def list_connectors(self) -> dict:
        return self._req("GET", "/api/v1/connectors")

    # ------------------------------------------- connection tables/profiles

    def create_connection_profile(self, name: str, connector: str,
                                  config: Optional[dict] = None) -> dict:
        return self._req("POST", "/api/v1/connection_profiles",
                         {"name": name, "connector": connector,
                          "config": config or {}})

    def list_connection_profiles(self) -> list[dict]:
        return self._req("GET", "/api/v1/connection_profiles")["data"]

    def delete_connection_profile(self, profile_id: str) -> dict:
        return self._req("DELETE", f"/api/v1/connection_profiles/{profile_id}")

    def create_connection_table(self, name: str, connector: str,
                                table_type: str = "source",
                                config: Optional[dict] = None,
                                schema_fields: Optional[list[dict]] = None,
                                profile_id: Optional[str] = None) -> dict:
        body: dict = {"name": name, "connector": connector,
                      "table_type": table_type, "config": config or {},
                      "schema_fields": schema_fields or []}
        if profile_id:
            body["profile_id"] = profile_id
        return self._req("POST", "/api/v1/connection_tables", body)

    def list_connection_tables(self) -> list[dict]:
        return self._req("GET", "/api/v1/connection_tables")["data"]

    def delete_connection_table(self, table_id: str) -> dict:
        return self._req("DELETE", f"/api/v1/connection_tables/{table_id}")

    def test_connection_table(self, **spec) -> dict:
        return self._req("POST", "/api/v1/connection_tables/test", spec)

    def create_udf(self, name: str, source: str, language: str = "cpp",
                   arg_dtypes: Optional[list[str]] = None,
                   return_dtype: str = "float64") -> dict:
        return self._req("POST", "/api/v1/udfs", {
            "name": name, "source": source, "language": language,
            "arg_dtypes": arg_dtypes or [], "return_dtype": return_dtype,
        })

    def list_udfs(self) -> dict:
        return self._req("GET", "/api/v1/udfs")

    def delete_udf(self, name: str) -> dict:
        return self._req("DELETE", f"/api/v1/udfs/{urllib.parse.quote(name)}")

    def register_node(self, node_id: str, addr: str, slots: int = 16) -> dict:
        return self._req("POST", "/api/v1/nodes/register",
                         {"node_id": node_id, "addr": addr, "slots": slots})

    def node_heartbeat(self, node_id: str) -> dict:
        return self._req("POST", f"/api/v1/nodes/{node_id}/heartbeat", {})

    def list_nodes(self) -> list[dict]:
        return self._req("GET", "/api/v1/nodes")["nodes"]

    # ----------------------------------------------------------- convenience

    def run_to_state(self, job_id: str, *states: str, timeout: float = 120.0):
        """Poll until the job reaches one of ``states`` (client-side analog
        of the integ tests' wait loops)."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.get_job(job_id)
            if job.get("state") in states:
                return job
            if job.get("state") == "Failed" and "Failed" not in states:
                raise RuntimeError(f"job failed: {job.get('failure_message')}")
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} never reached {states}")
