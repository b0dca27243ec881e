"""REST API: pipeline/job CRUD over the shared DB.

The port's copy of arroyo_tpu/api/server.py.

Reference: crates/arroyo-api/src/rest.rs:127-181 route table (axum). Same
resource model: pipelines are validated SQL; creating one starts a job; jobs
are stopped by PATCHing desired_stop; checkpoints are queryable. Served with
the stdlib ThreadingHTTPServer — the API is off the data path.

Routes:
  GET    /api/v1/ping
  POST   /api/v1/pipelines/validate   {"query"}           -> {"valid", "errors"}
  POST   /api/v1/pipelines            {"name","query","parallelism"}
  GET    /api/v1/pipelines
  GET    /api/v1/pipelines/{id}
  DELETE /api/v1/pipelines/{id}
  GET    /api/v1/pipelines/{id}/jobs
  POST   /api/v1/pipelines/{id}/evolve {"query"}           -> classification
  GET    /api/v1/jobs
  GET    /api/v1/jobs/{id}
  PATCH  /api/v1/jobs/{id}            {"stop": "checkpoint"|"immediate"} |
                                      {"action": "restart"}
  GET    /api/v1/jobs/{id}/checkpoints
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..controller.db import Database


class ApiServer:
    """Trust model: by default the API trusts its network — anyone who can
    reach the port can register UDFs (which execute user code on the
    cluster, same exposure as the reference's UDF surface) and manage
    pipelines. Deployments beyond localhost should set ``api.auth-token``
    (ARROYO_TPU_TORCH__API__AUTH_TOKEN): every mutating request (non-GET) must
    then carry ``Authorization: Bearer <token>``; reads stay open for
    dashboards. The node daemon and typed client pick the token up from
    the same config."""

    def __init__(self, db: Database, port: int = 0, host: str = "127.0.0.1"):
        from ..config import config

        self.db = db
        self.auth_token = config().get("api.auth-token")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence default stderr spam
                pass

            def _json(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                if not n:
                    return {}
                try:
                    return json.loads(self.rfile.read(n))
                except json.JSONDecodeError:
                    return {}

            def do_GET(self):
                outer._route(self, "GET")

            def do_POST(self):
                outer._route(self, "POST")

            def do_PATCH(self):
                outer._route(self, "PATCH")

            def do_DELETE(self):
                outer._route(self, "DELETE")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- routing

    _ROUTES = [
        ("GET", r"^/$", "_webui"),
        ("GET", r"^/webui/([A-Za-z0-9_.-]+)$", "_webui_asset"),
        ("GET", r"^/api/v1/openapi\.json$", "_openapi"),
        ("GET", r"^/api/v1/ping$", "_ping"),
        ("POST", r"^/api/v1/pipelines/validate$", "_validate"),
        ("POST", r"^/api/v1/pipelines$", "_create_pipeline"),
        ("GET", r"^/api/v1/pipelines$", "_list_pipelines"),
        ("GET", r"^/api/v1/pipelines/([^/]+)$", "_get_pipeline"),
        ("DELETE", r"^/api/v1/pipelines/([^/]+)$", "_delete_pipeline"),
        ("GET", r"^/api/v1/pipelines/([^/]+)/jobs$", "_pipeline_jobs"),
        ("GET", r"^/api/v1/pipelines/([^/]+)/graph$", "_pipeline_graph"),
        ("POST", r"^/api/v1/pipelines/([^/]+)/evolve$", "_evolve_pipeline"),
        ("GET", r"^/api/v1/jobs$", "_list_jobs"),
        ("GET", r"^/api/v1/jobs/([^/]+)$", "_get_job"),
        ("PATCH", r"^/api/v1/jobs/([^/]+)$", "_patch_job"),
        ("GET", r"^/api/v1/jobs/([^/]+)/checkpoints$", "_job_checkpoints"),
        ("GET", r"^/api/v1/jobs/([^/]+)/output$", "_job_output"),
        ("GET", r"^/api/v1/jobs/([^/]+)/metrics$", "_job_metrics"),
        ("GET", r"^/api/v1/jobs/([^/]+)/profile$", "_job_profile"),
        ("GET", r"^/api/v1/jobs/([^/]+)/traces$", "_job_traces"),
        ("GET", r"^/api/v1/jobs/([^/]+)/events$", "_job_events"),
        ("GET", r"^/api/v1/jobs/([^/]+)/health$", "_job_health"),
        ("GET", r"^/api/v1/jobs/([^/]+)/fsck$", "_job_fsck"),
        ("GET", r"^/api/v1/fleet$", "_fleet"),
        ("GET", r"^/api/v1/connectors$", "_connectors"),
        ("POST", r"^/api/v1/connection_profiles$", "_create_profile"),
        ("GET", r"^/api/v1/connection_profiles$", "_list_profiles"),
        ("DELETE", r"^/api/v1/connection_profiles/([^/]+)$", "_delete_profile"),
        ("POST", r"^/api/v1/connection_tables$", "_create_conn_table"),
        ("GET", r"^/api/v1/connection_tables$", "_list_conn_tables"),
        ("DELETE", r"^/api/v1/connection_tables/([^/]+)$", "_delete_conn_table"),
        ("POST", r"^/api/v1/connection_tables/test$", "_test_conn_table"),
        ("POST", r"^/api/v1/nodes/register$", "_register_node"),
        ("POST", r"^/api/v1/nodes/([^/]+)/heartbeat$", "_node_heartbeat"),
        ("GET", r"^/api/v1/nodes$", "_list_nodes"),
        ("POST", r"^/api/v1/udfs$", "_create_udf"),
        ("GET", r"^/api/v1/udfs$", "_list_udfs"),
        ("DELETE", r"^/api/v1/udfs/([^/]+)$", "_delete_udf"),
    ]

    def _route(self, h, method: str) -> None:
        path = h.path.split("?", 1)[0]
        if self.auth_token and method != "GET":
            # shared-token gate on every mutating endpoint (the UDF surface
            # is remote code execution by design; see the class docstring
            # for the trust model)
            if h.headers.get("Authorization") != f"Bearer {self.auth_token}":
                h._json(401, {"error": "missing or invalid bearer token"})
                return
        for m, pat, name in self._ROUTES:
            if m != method:
                continue
            match = re.match(pat, path)
            if match:
                try:
                    getattr(self, name)(h, *match.groups())
                except Exception as e:  # noqa: BLE001
                    h._json(500, {"error": str(e)})
                return
        h._json(404, {"error": f"no route {method} {path}"})

    # ------------------------------------------------------------ handlers

    def _ping(self, h):
        h._json(200, {"pong": True})

    def _openapi(self, h):
        from .openapi import spec

        h._json(200, spec())

    _WEBUI_TYPES = {".html": "text/html; charset=utf-8",
                    ".js": "text/javascript; charset=utf-8",
                    ".css": "text/css; charset=utf-8",
                    ".svg": "image/svg+xml"}

    def _serve_webui_file(self, h, name: str) -> None:
        import os

        base = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "webui")
        path = os.path.join(base, name)
        # route regex forbids path separators; keep the normpath guard anyway
        if not os.path.normpath(path).startswith(base) or not os.path.isfile(path):
            h._json(404, {"error": f"no asset {name!r}"})
            return
        with open(path, "rb") as f:
            data = f.read()
        ext = os.path.splitext(name)[1]
        h.send_response(200)
        h.send_header("Content-Type",
                      self._WEBUI_TYPES.get(ext, "application/octet-stream"))
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _webui(self, h):
        self._serve_webui_file(h, "index.html")

    def _webui_asset(self, h, name):
        self._serve_webui_file(h, name)

    def _activate_udfs(self) -> None:
        from ..compiler import activate_udf_specs

        rows = self.db.list_udfs()
        # registry is process-global: re-executing N user sources on every
        # validate/create request is waste — only re-activate on change
        fp = tuple(sorted((r["name"], r["created_at"], r["source"]) for r in rows))
        if fp == getattr(self, "_udf_fingerprint", None):
            return
        activate_udf_specs(rows)
        self._udf_fingerprint = fp

    def _validate(self, h):
        from ..sql import plan_query
        from ..sql.lexer import SqlError

        body = h._body()
        try:
            self._activate_udfs()
            plan_query(body.get("query", ""),
                       connection_tables=self.db.list_connection_tables())
            h._json(200, {"valid": True, "errors": []})
        except SqlError as e:
            h._json(200, {"valid": False, "errors": [str(e)]})

    def _register_node(self, h):
        body = h._body()
        self.db.register_node(body["node_id"], body["addr"], int(body.get("slots", 16)))
        h._json(200, {"registered": body["node_id"]})

    def _node_heartbeat(self, h, node_id):
        if self.db.node_heartbeat(node_id):
            h._json(200, {})
        else:
            h._json(404, {"error": "unknown node (re-register)"})

    def _list_nodes(self, h):
        h._json(200, {"nodes": self.db.list_nodes()})

    def _create_udf(self, h):
        """Create a UDF: a cpp source compiles through the compile service
        (in-process, or ``compiler.endpoint``'s), its artifact published to
        storage; python sources are stored and executed at plan and worker
        start."""
        from ..compiler import activate_udf_specs, compile_udf

        body = h._body()
        name = body.get("name")
        language = body.get("language", "cpp")
        source = body.get("source")
        if not name or not source:
            h._json(400, {"error": "name and source are required"})
            return
        artifact = None
        arg_dtypes = list(body.get("arg_dtypes", []))
        return_dtype = body.get("return_dtype", "float64")
        try:
            if language == "cpp":
                # the remote compile service when compiler.endpoint is set
                spec = compile_udf(name, source, arg_dtypes, return_dtype)
                artifact = spec.artifact_url
            self.db.create_udf(name, language, source, arg_dtypes, return_dtype, artifact)
            try:
                # a source that fails to activate must not stay persisted, or
                # it would poison every later validate/create
                activate_udf_specs([{
                    "name": name, "language": language, "source": source,
                    "arg_dtypes": arg_dtypes, "return_dtype": return_dtype,
                    "artifact_url": artifact,
                }])
            except Exception:
                self.db.delete_udf(name)
                raise
        except Exception as e:  # user code raises anything
            h._json(400, {"error": f"UDF rejected: {e}"})
            return
        h._json(200, {"name": name, "language": language, "artifact_url": artifact})

    def _list_udfs(self, h):
        h._json(200, {"udfs": [
            {k: u[k] for k in ("name", "language", "return_dtype", "arg_dtypes", "artifact_url")}
            for u in self.db.list_udfs()
        ]})

    def _delete_udf(self, h, name):
        from ..udf import drop_udaf, drop_udf

        self.db.delete_udf(name)
        drop_udf(name)
        drop_udaf(name)
        h._json(200, {"deleted": name})

    def _create_pipeline(self, h):
        from ..sql import plan_query
        from ..sql.lexer import SqlError

        body = h._body()
        name = body.get("name") or "pipeline"
        query = body.get("query")
        if not query:
            h._json(400, {"error": "query is required"})
            return
        try:
            self._activate_udfs()
            plan_query(query, connection_tables=self.db.list_connection_tables())
        except SqlError as e:
            h._json(400, {"error": f"invalid query: {e}"})
            return
        parallelism = int(body.get("parallelism", 1))
        pid = self.db.create_pipeline(name, query, parallelism)
        # tenant keys the fleet's per-tenant admission queues and quotas
        jid = self.db.create_job(pid, tenant=str(body.get("tenant")
                                                 or "default"))
        h._json(200, {"id": pid, "name": name, "job_id": jid})

    def _list_pipelines(self, h):
        h._json(200, {"data": self.db.list_pipelines()})

    def _get_pipeline(self, h, pid):
        p = self.db.get_pipeline(pid)
        h._json(200, p) if p else h._json(404, {"error": "not found"})

    def _delete_pipeline(self, h, pid):
        for job in self.db.list_jobs(pid):
            if job["state"] not in ("Failed", "Finished", "Stopped"):
                h._json(409, {"error": "stop the pipeline's jobs first"})
                return
        self.db.delete_pipeline(pid)
        h._json(200, {"deleted": pid})

    def _pipeline_jobs(self, h, pid):
        h._json(200, {"data": self.db.list_jobs(pid)})

    def _pipeline_graph(self, h, pid):
        """Planned dataflow DAG for the UI's graph view (reference
        PipelineGraph.tsx consumes the pipeline's edges/nodes)."""
        from ..sql.lexer import SqlError
        from ..sql.planner import executed_graph_view

        p = self.db.get_pipeline(pid)
        if not p:
            h._json(404, {"error": "not found"})
            return
        try:
            self._activate_udfs()
            # the DAG as it EXECUTES (parallelism + chaining), so node ids
            # line up with runtime metric/profile keys — see the helper
            nodes, edges = executed_graph_view(
                p["query"], int(p.get("parallelism") or 1),
                connection_tables=self.db.list_connection_tables())
        except SqlError as e:
            h._json(400, {"error": str(e)})
            return
        h._json(200, {"nodes": nodes, "edges": edges})

    def _evolve_pipeline(self, h, pid):
        """Live evolution (versioned redeploy): validate the evolved SQL,
        run the plan-diff pass against the CURRENT query, and — only when
        no AR-series ERROR rejects the carry-over — hand the controller a
        ``desired_query`` to actuate (drain behind a final checkpoint,
        restore the evolved plan through the proven mapping, blue/green
        cutover). An incompatible evolution is rejected HERE, at plan
        time: it never reaches Scheduling and the running job is never
        touched."""
        from ..analysis.plan_diff import diff_plans
        from ..sql import plan_query
        from ..sql.lexer import SqlError

        p = self.db.get_pipeline(pid)
        if not p:
            h._json(404, {"error": "not found"})
            return
        body = h._body()
        query = body.get("query")
        if not query:
            h._json(400, {"error": "query is required"})
            return
        try:
            self._activate_udfs()
            scope = self.db.list_connection_tables()
            old_graph = plan_query(p["query"],
                                   connection_tables=scope).graph
            new_graph = plan_query(query, connection_tables=scope).graph
        except SqlError as e:
            h._json(400, {"error": f"invalid query: {e}"})
            return
        diff = diff_plans(old_graph, new_graph)
        payload = {
            "classifications": [c.to_json() for c in diff.classifications],
            "diagnostics": [d.to_dict() for d in diff.diagnostics],
        }
        if diff.rejected:
            errs = "; ".join(f"{d.rule_id}: {d.message}"
                             for d in diff.diagnostics
                             if d.severity.name == "ERROR")
            h._json(400, {"error": f"evolution rejected: {errs}", **payload})
            return
        live = [j for j in self.db.list_jobs(pid)
                if j["state"] not in ("Failed", "Finished", "Stopped")]
        if not live:
            h._json(409, {"error": "pipeline has no live job to evolve; "
                                   "restart it first"})
            return
        jid = live[-1]["id"]
        if query == p["query"]:
            h._json(200, {"id": pid, "job_id": jid, "noop": True, **payload})
            return
        self.db.update_job(jid, desired_query=query)
        h._json(200, {"id": pid, "job_id": jid,
                      "version": int(p.get("version") or 1) + 1, **payload})

    def _list_jobs(self, h):
        h._json(200, {"data": self.db.list_jobs()})

    def _get_job(self, h, jid):
        j = self.db.get_job(jid)
        if not j:
            h._json(404, {"error": "not found"})
            return
        if j.get("state") == "Queued":
            # surface the admission-queue position from the controller's
            # persisted fleet snapshot (cross-process: the API only has
            # the DB)
            pos = self.db.fleet_queue_position(jid)
            if pos is not None:
                j["queue_position"] = pos
        h._json(200, j)

    def _fleet(self, h):
        """Multi-tenant fleet snapshot (controller/fleet.py): pool size,
        used/free slots, per-tenant usage + quota queue depth, and the
        admission queue with positions."""
        h._json(200, self.db.get_fleet_state() or {
            "pool_slots": None, "slots_used": 0, "slots_free": None,
            "target_workers": 0, "queue_depth": {}, "queue": [],
            "tenants": {}})

    def _patch_job(self, h, jid):
        j = self.db.get_job(jid)
        if not j:
            h._json(404, {"error": "not found"})
            return
        body = h._body()
        if body.get("action") == "restart":
            self.db.update_job(jid, state="Restarting", desired_stop=None)
            h._json(200, {"id": jid, "state": "Restarting"})
            return
        if "parallelism" in body:
            # live rescale (reference jobs.rs parallelism patch +
            # states/rescaling.rs): the controller checkpoints-and-stops the
            # running worker, then reschedules at the new parallelism
            want = body["parallelism"]
            # bool is an int subclass; floats must not silently truncate
            if isinstance(want, bool) or not isinstance(want, int):
                h._json(400, {"error": "parallelism must be an integer"})
                return
            if want < 1:
                h._json(400, {"error": "parallelism must be >= 1"})
                return
            if j["state"] not in ("Running", "Scheduling", "Created", "Compiling"):
                h._json(409, {"error": f"cannot rescale a {j['state']} job"})
                return
            self.db.update_job(jid, desired_parallelism=want)
            h._json(200, {"id": jid, "desired_parallelism": want})
            return
        stop = body.get("stop")
        if stop not in ("checkpoint", "immediate"):
            h._json(400, {"error": "stop must be 'checkpoint' or 'immediate'"})
            return
        self.db.update_job(jid, desired_stop=stop)
        h._json(200, {"id": jid, "desired_stop": stop})

    def _job_checkpoints(self, h, jid):
        h._json(200, {"data": self.db.list_checkpoints(jid)})

    def _job_output(self, h, jid):
        # ?after=<seq> for incremental tailing (reference SubscribeToOutput)
        after = -1
        if "?" in h.path:
            from urllib.parse import parse_qs

            q = parse_qs(h.path.split("?", 1)[1])
            after = int(q.get("after", ["-1"])[0])
        h._json(200, {"data": self.db.list_outputs(jid, after_seq=after)})

    def _job_traces(self, h, jid):
        """Epoch-lifecycle traces (obs.trace): Chrome trace-event JSON by
        default (loads directly in chrome://tracing / Perfetto's legacy-UI
        importer); ``?format=events`` returns the raw span events (the
        `trace --report` CLI renders timelines from these); ``?epoch=N``
        restricts either form to one epoch."""
        from urllib.parse import parse_qs

        from ..obs import events as obs_events
        from ..obs import trace as obs_trace

        q = parse_qs(h.path.split("?", 1)[1]) if "?" in h.path else {}
        epoch = int(q["epoch"][0]) if q.get("epoch") else None
        # DB-persisted rows (written by the controller) cover every
        # scheduler; the in-process recorder — when this process has one for
        # the job — is always at least as complete (DB rows are snapshots of
        # it taken at checkpoint-complete time, before late commit spans), so
        # recorder events win per epoch
        rows = self.db.list_traces(jid, epoch=epoch)
        by_epoch = {r["epoch"]: r["events"] for r in rows}
        for e in obs_trace.recorder.epochs(jid):
            if epoch is None or e == epoch:
                by_epoch[e] = obs_trace.recorder.events(jid, e)
        if q.get("format", [""])[0] == "events":
            h._json(200, {"job_id": jid, "epochs": {
                str(e): evs for e, evs in sorted(by_epoch.items())}})
            return
        # epoch-scoped job events render as instant markers on the same
        # timeline, so spans and the event feed correlate in one view
        job_events = self.db.list_events(jid) or obs_events.recorder.events(jid)
        h._json(200, obs_trace.chrome_trace(jid, by_epoch,
                                            job_events=job_events))

    def _job_events(self, h, jid):
        """Structured job event feed (obs.events): the controller-persisted
        rows, oldest first. ``?level=WARN`` filters to a minimum level,
        ``?since=<unix seconds>`` to a wall-time floor, ``?after=<seq>`` is
        the incremental-tail cursor the `logs --follow` CLI uses. Falls
        back to the in-process ring for jobs whose controller shares this
        process and has not flushed yet."""
        from urllib.parse import parse_qs

        from ..obs import events as obs_events

        q = parse_qs(h.path.split("?", 1)[1]) if "?" in h.path else {}
        level = q.get("level", [None])[0]
        since = float(q["since"][0]) if q.get("since") else None
        after = int(q.get("after", ["0"])[0])
        data = self.db.list_events(jid, level=level, since=since,
                                   after_seq=after)
        if not data:
            data = obs_events.recorder.events(
                jid, level=level,
                since_us=None if since is None else int(since * 1e6),
                after_seq=after or None)
        h._json(200, {"job_id": jid, "data": data})

    def _job_health(self, h, jid):
        """Job health with per-rule detail (obs.health): state plus each
        rule's observed value, threshold, and firing flag — what the
        autoscaler (and `top`'s header) read."""
        job = self.db.get_job(jid)
        if not job:
            h._json(404, {"error": "not found"})
            return
        detail = self.db.get_health(jid) or {
            "state": job.get("health") or "ok", "rules": []}
        h._json(200, {"job_id": jid, **detail})

    def _job_fsck(self, h, jid):
        """Offline checkpoint-chain verification (state.integrity.fsck_job):
        walks every epoch's artifacts — marker checksum, sidecar and
        table-file envelopes, spill-run liveness and footers,
        evolution-mapping pairing, orphans — and returns the FS-series
        diagnostics. ``clean`` is False iff any ERROR finding exists (the
        same predicate as `arroyo_tpu_torch fsck`'s exit code);
        ``?storage_url=`` overrides the configured checkpoint store."""
        from urllib.parse import parse_qs

        from ..analysis import Severity
        from ..config import config
        from ..state.integrity import fsck_job

        q = parse_qs(h.path.split("?", 1)[1]) if "?" in h.path else {}
        storage_url = (q["storage_url"][0] if q.get("storage_url")
                       else str(config().get("checkpoint.storage-url")))
        diags = fsck_job(storage_url, jid)
        h._json(200, {
            "job_id": jid,
            "storage_url": storage_url,
            "clean": not any(d.severity == Severity.ERROR for d in diags),
            "diagnostics": [d.to_dict() for d in diags],
        })

    def _job_metrics(self, h, jid):
        # DB-persisted snapshots (shipped from workers over the control
        # protocol) cover the process scheduler; fall back to the local
        # registry for an in-flight embedded job
        data = self.db.get_metrics(jid)
        if data is None:
            from ..metrics import registry as metrics_registry

            data = metrics_registry.job_metrics(jid)
        h._json(200, {"data": data})

    def _job_profile(self, h, jid):
        """Runtime cost profile (obs.profile): per-operator busy%, self-time
        by category, state rows/bytes per table, merged top-k hot keys, and
        late-row drops — the controller-persisted snapshot, falling back to
        a live derivation from the local registry for embedded jobs."""
        data = self.db.get_profile(jid)
        if data is None:
            from ..metrics import registry as metrics_registry
            from ..obs.profile import job_profile

            data = job_profile(metrics_registry.job_metrics(jid))
        h._json(200, {"data": data})

    def _connectors(self, h):
        from ..connectors import connectors

        h._json(200, connectors())

    # ------------------------------------------- connection tables/profiles
    # (reference arroyo-api/src/rest.rs:144-158 connection_profiles +
    # connection_tables CRUD; registered tables are usable by name in
    # pipeline SQL with no inline DDL)

    def _create_profile(self, h):
        body = h._body()
        for field in ("name", "connector"):
            if not body.get(field):
                h._json(400, {"error": f"missing {field!r}"})
                return
        if any(p["name"] == body["name"]
               for p in self.db.list_connection_profiles()):
            h._json(409, {"error": f"profile {body['name']!r} already exists"})
            return
        cid = self.db.create_connection_profile(
            body["name"], body["connector"], body.get("config") or {})
        h._json(200, {"id": cid, "name": body["name"]})

    def _list_profiles(self, h):
        h._json(200, {"data": self.db.list_connection_profiles()})

    def _delete_profile(self, h, cid):
        if not self.db.delete_connection_profile(cid):
            h._json(409, {"error": "profile is referenced by connection tables"})
            return
        h._json(200, {"deleted": cid})

    def _validate_conn_table(self, body) -> Optional[str]:
        """Reason the spec is invalid, or None when usable."""
        from ..connectors import connectors

        for field in ("name", "connector"):
            if not body.get(field):
                return f"missing {field!r}"
        ttype = body.get("table_type", "source")
        if ttype not in ("source", "sink"):
            return "table_type must be 'source' or 'sink'"
        avail = connectors()
        reg = avail["sources"] if ttype == "source" else avail["sinks"]
        if body["connector"] not in reg:
            return (f"unknown {ttype} connector {body['connector']!r} "
                    f"(have {sorted(reg)})")
        fields = body.get("schema_fields") or []
        if ttype == "source" and not fields and body["connector"] not in (
                "impulse", "nexmark"):
            return "source connection tables need at least one schema field"
        from ..sql.compile import sql_type_to_dtype
        from ..sql.lexer import SqlError

        for f in fields:
            try:
                sql_type_to_dtype(str(f.get("type", "")))
            except SqlError as e:
                return f"field {f.get('name')!r}: {e}"
        return None

    def _test_conn_table(self, h):
        err = self._validate_conn_table(h._body())
        h._json(200, {"ok": err is None, "error": err})

    def _create_conn_table(self, h):
        body = h._body()
        err = self._validate_conn_table(body)
        if err:
            h._json(400, {"error": err})
            return
        if any(t["name"] == body["name"]
               for t in self.db.list_connection_tables()):
            h._json(409, {"error": f"connection table {body['name']!r} "
                          "already exists"})
            return
        profile_id = body.get("profile_id")
        config = dict(body.get("config") or {})
        if profile_id:
            prof = next((p for p in self.db.list_connection_profiles()
                         if p["id"] == profile_id), None)
            if prof is None:
                h._json(404, {"error": "unknown connection profile"})
                return
            # table options override the profile's shared options
            config = {**prof["config"], **config}
        tid = self.db.create_connection_table(
            body["name"], body["connector"], body.get("table_type", "source"),
            config, body.get("schema_fields") or [], profile_id)
        h._json(200, {"id": tid, "name": body["name"]})

    def _list_conn_tables(self, h):
        h._json(200, {"data": self.db.list_connection_tables()})

    def _delete_conn_table(self, h, tid):
        self.db.delete_connection_table(tid)
        h._json(200, {"deleted": tid})

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="api-server"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
