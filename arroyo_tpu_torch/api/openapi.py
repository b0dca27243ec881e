"""OpenAPI 3.0 description of the REST API.

The port's copy of arroyo_tpu/api/openapi.py.

Equivalent of the reference's utoipa-generated spec that feeds
crates/arroyo-openapi (the generated client) and the web UI's typed
bindings (webui/src/gen). The spec is built from the same route table the
server dispatches on, so paths can't drift from the implementation; a
test asserts the client (client.py) covers every operation.
Served at GET /api/v1/openapi.json.
"""

from __future__ import annotations

_OBJ = {"type": "object"}
_STR = {"type": "string"}
_INT = {"type": "integer"}


def _op(op_id: str, summary: str, params: list[str] = (),
        body: dict | None = None, response: dict | None = None) -> dict:
    out: dict = {
        "operationId": op_id,
        "summary": summary,
        "parameters": [
            {"name": p, "in": "path", "required": True, "schema": _STR}
            for p in params
        ],
        "responses": {
            "200": {
                "description": "success",
                "content": {"application/json": {"schema": response or _OBJ}},
            }
        },
    }
    if body is not None:
        out["requestBody"] = {
            "required": True,
            "content": {"application/json": {"schema": body}},
        }
    return out


PIPELINE = {
    "type": "object",
    "properties": {"id": _STR, "name": _STR, "query": _STR, "parallelism": _INT},
}
JOB = {
    "type": "object",
    "properties": {
        "id": _STR, "pipeline_id": _STR, "state": _STR,
        "restarts": _INT, "checkpoint_epoch": _INT,
        "n_workers": _INT,  # size of the job's running worker set
        # ok | degraded | critical (controller health monitors)
        "health": _STR,
        # multi-tenant fleet: the tenant keying admission queues/quotas,
        # and (Queued jobs only) the 1-based admission-queue position
        "tenant": _STR,
        "queue_position": _INT,
    },
}
FLEET = {
    "type": "object",
    "properties": {
        # null pool_slots/slots_free = unlimited (fleet pass-through)
        "pool_slots": _INT,
        "slots_used": _INT,
        "slots_free": _INT,
        # the fleet autoscaler's pool target — for externally sized pools
        # (node daemons, k8s node pools) this is the scaling knob
        "target_workers": _INT,
        "queue_depth": {"type": "object",
                        "additionalProperties": _INT},
        "queue": {"type": "array", "items": {
            "type": "object",
            "properties": {"job_id": _STR, "tenant": _STR,
                           "slots": _INT, "position": _INT}}},
        "tenants": {"type": "object", "additionalProperties": {
            "type": "object",
            "properties": {"slots_used": _INT, "jobs_running": _INT,
                           "queued": _INT}}},
    },
}
JOB_EVENT = {
    "type": "object",
    "properties": {
        "seq": _INT, "ts_us": _INT,
        "level": {"type": "string",
                  "enum": ["DEBUG", "INFO", "WARN", "ERROR"]},
        "code": _STR,  # stable EventCode (see README "Events & health")
        "node": _STR, "subtask": _INT, "worker": _INT, "epoch": _INT,
        "message": _STR, "data": {"type": "object"},
    },
}
JOB_HEALTH = {
    "type": "object",
    "properties": {
        "job_id": _STR,
        "state": {"type": "string", "enum": ["ok", "degraded", "critical"]},
        "rules": {"type": "array", "items": {
            "type": "object",
            "properties": {
                "rule": _STR, "severity": _STR, "description": _STR,
                "value": {"type": "number"}, "threshold": {"type": "number"},
                "breaching": {"type": "boolean"},
                "firing": {"type": "boolean"},
            }}},
        # elastic-autoscaler readout (controller/autoscaler.py): rail
        # state, live signals, and the last decision
        "autoscaler": {
            "type": "object",
            "properties": {
                "enabled": {"type": "boolean"},
                "parallelism": {"type": "integer"},
                "target": {"type": "integer"},
                "in_flight": {"type": "boolean"},
                "up_ticks": {"type": "integer"},
                "down_ticks": {"type": "integer"},
                "cooldown_remaining_s": {"type": "number"},
                "backoff_remaining_s": {"type": "number"},
                "failures": {"type": "integer"},
                "signals": {"type": "array", "items": {
                    "type": "object",
                    "properties": {
                        "signal": _STR, "value": {"type": "number"},
                        "threshold": {"type": "number"},
                        # pressure rows carry `breaching` (true = bad);
                        # the headroom row carries `proven` (true = idle
                        # enough to scale down) — opposite polarity
                        "breaching": {"type": "boolean"},
                        "proven": {"type": "boolean"},
                    }}},
                "last_decision": {"type": "object"},
            },
        },
    },
}
UDF = {
    "type": "object",
    "properties": {
        "name": _STR, "language": {"type": "string", "enum": ["cpp", "python"]},
        "source": _STR, "arg_dtypes": {"type": "array", "items": _STR},
        "return_dtype": _STR,
    },
    "required": ["name", "source"],
}
NODE = {
    "type": "object",
    "properties": {"node_id": _STR, "addr": _STR, "slots": _INT},
    "required": ["node_id", "addr"],
}
CONNECTION_PROFILE = {
    "type": "object",
    "properties": {"name": _STR, "connector": _STR,
                   "config": {"type": "object"}},
    "required": ["name", "connector"],
}
CONNECTION_TABLE = {
    "type": "object",
    "properties": {
        "name": _STR, "connector": _STR,
        "table_type": {"type": "string", "enum": ["source", "sink"]},
        "profile_id": _STR,
        "config": {"type": "object"},
        "schema_fields": {"type": "array", "items": {
            "type": "object",
            "properties": {"name": _STR, "type": _STR,
                           "nullable": {"type": "boolean"}},
            "required": ["name", "type"]}},
    },
    "required": ["name", "connector"],
}


def spec() -> dict:
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "arroyo-tpu REST API",
            "version": "1.0.0",
            "description": "Pipeline/job/UDF/node management for the "
                           "TPU-native streaming engine.",
        },
        "paths": {
            "/api/v1/ping": {"get": _op("ping", "liveness probe")},
            "/api/v1/pipelines/validate": {
                "post": _op("validate_query", "validate SQL without creating",
                            body={"type": "object", "properties": {"query": _STR},
                                  "required": ["query"]})},
            "/api/v1/pipelines": {
                "post": _op("create_pipeline", "create pipeline + job",
                            body={"type": "object",
                                  "properties": {"name": _STR, "query": _STR,
                                                 "parallelism": _INT,
                                                 # fleet admission/quota key
                                                 "tenant": _STR},
                                  "required": ["query"]}),
                "get": _op("list_pipelines", "list pipelines",
                           response={"type": "object",
                                     "properties": {"data": {"type": "array",
                                                             "items": PIPELINE}}})},
            "/api/v1/pipelines/{pipeline_id}": {
                "get": _op("get_pipeline", "fetch one pipeline", ["pipeline_id"],
                           response=PIPELINE),
                "delete": _op("delete_pipeline", "delete pipeline + jobs",
                              ["pipeline_id"])},
            "/api/v1/pipelines/{pipeline_id}/graph": {
                "get": _op("pipeline_graph", "planned dataflow DAG",
                           ["pipeline_id"],
                           response={"type": "object", "properties": {
                               "nodes": {"type": "array", "items": {
                                   "type": "object", "properties": {
                                       "id": _STR, "op": _STR,
                                       "description": _STR,
                                       "parallelism": _INT,
                                       # chained run marked for whole-
                                       # segment compilation (plan-time;
                                       # runtime truth is the profile's
                                       # segment_compiled flag)
                                       "compilable": {"type": "boolean"}}}},
                               "edges": {"type": "array", "items": {
                                   "type": "object", "properties": {
                                       "src": _STR, "dst": _STR,
                                       "type": _STR}}}}})},
            "/api/v1/pipelines/{pipeline_id}/evolve": {
                "post": _op(
                    "evolve_pipeline",
                    "live evolution (versioned redeploy): plan-diff the "
                    "evolved SQL against the current plan; on success the "
                    "running job drains behind a final checkpoint, carries "
                    "proven state, and cuts over blue/green — an "
                    "incompatible change is rejected here with AR-series "
                    "diagnostics and never touches the job",
                    ["pipeline_id"],
                    body={"type": "object",
                          "properties": {"query": _STR},
                          "required": ["query"]},
                    response={"type": "object", "properties": {
                        "id": _STR, "job_id": _STR, "version": _INT,
                        "classifications": {"type": "array", "items": {
                            "type": "object", "properties": {
                                "node_id": _STR,
                                "action": {"type": "string",
                                           "enum": ["carried", "rebuilt",
                                                    "dropped", "stateless",
                                                    "incompatible"]},
                                "from": _STR, "detail": _STR}}},
                        "diagnostics": {"type": "array", "items": {
                            "type": "object", "properties": {
                                "rule": _STR, "severity": _STR,
                                "site": _STR, "message": _STR,
                                "hint": _STR}}}}})},
            "/api/v1/pipelines/{pipeline_id}/jobs": {
                "get": _op("pipeline_jobs", "jobs of a pipeline", ["pipeline_id"],
                           response={"type": "object",
                                     "properties": {"data": {"type": "array",
                                                             "items": JOB}}})},
            "/api/v1/jobs": {
                "get": _op("list_jobs", "list all jobs")},
            "/api/v1/jobs/{job_id}": {
                "get": _op("get_job", "fetch one job", ["job_id"], response=JOB),
                "patch": _op("patch_job", "stop / rescale a job", ["job_id"],
                             body={"type": "object",
                                   "properties": {"stop": {"type": "string",
                                                           "enum": ["checkpoint",
                                                                    "immediate",
                                                                    "none"]},
                                                  "parallelism": _INT}})},
            "/api/v1/jobs/{job_id}/checkpoints": {
                "get": _op("job_checkpoints", "checkpoint history", ["job_id"])},
            "/api/v1/jobs/{job_id}/output": {
                "get": _op("job_output", "preview sink rows", ["job_id"])},
            "/api/v1/jobs/{job_id}/metrics": {
                "get": _op("job_metrics", "operator metric groups", ["job_id"])},
            "/api/v1/jobs/{job_id}/profile": {
                "get": _op("job_profile", "runtime cost profile (per-operator "
                           "busy%, self-time, state sizes, hot keys)",
                           ["job_id"])},
            "/api/v1/jobs/{job_id}/traces": {
                "get": _op("job_traces", "checkpoint epoch traces "
                           "(Chrome trace-event JSON; ?format=events for "
                           "raw spans, ?epoch=N to restrict)", ["job_id"])},
            "/api/v1/jobs/{job_id}/events": {
                "get": _op("job_events", "structured job event feed "
                           "(?level= minimum level, ?since= unix seconds, "
                           "?after= seq cursor for tailing)", ["job_id"],
                           response={"type": "object", "properties": {
                               "job_id": _STR,
                               "data": {"type": "array", "items": JOB_EVENT},
                           }})},
            "/api/v1/jobs/{job_id}/health": {
                "get": _op("job_health", "job health state with per-rule "
                           "detail (hysteresis-filtered monitors over the "
                           "merged job metrics) plus the elastic "
                           "autoscaler's rail state and last decision",
                           ["job_id"],
                           response=JOB_HEALTH)},
            "/api/v1/jobs/{job_id}/fsck": {
                "get": _op("job_fsck", "offline checkpoint-chain "
                           "verification: marker checksums, sidecar and "
                           "table-file envelopes, spill-run liveness, "
                           "evolution-mapping pairing, orphans — FS-series "
                           "diagnostics; clean is false iff any ERROR",
                           ["job_id"],
                           response={"type": "object", "properties": {
                               "job_id": _STR,
                               "storage_url": _STR,
                               "clean": {"type": "boolean"},
                               "diagnostics": {"type": "array", "items": {
                                   "type": "object", "properties": {
                                       "rule": _STR, "severity": _STR,
                                       "site": _STR, "message": _STR,
                                       "hint": _STR}}}}})},
            "/api/v1/fleet": {
                "get": _op("fleet_status", "multi-tenant fleet snapshot: "
                           "pool occupancy, per-tenant usage, and the "
                           "admission queue with positions",
                           response=FLEET)},
            "/api/v1/connectors": {
                "get": _op("list_connectors", "available connectors")},
            "/api/v1/connection_profiles": {
                "post": _op("create_connection_profile",
                            "register shared connector options",
                            body=CONNECTION_PROFILE),
                "get": _op("list_connection_profiles",
                           "list connection profiles")},
            "/api/v1/connection_profiles/{id}": {
                "delete": _op("delete_connection_profile",
                              "drop an unreferenced profile", ["id"])},
            "/api/v1/connection_tables": {
                "post": _op("create_connection_table",
                            "register a named source/sink usable in SQL",
                            body=CONNECTION_TABLE),
                "get": _op("list_connection_tables", "list connection tables")},
            "/api/v1/connection_tables/{id}": {
                "delete": _op("delete_connection_table",
                              "drop a connection table", ["id"])},
            "/api/v1/connection_tables/test": {
                "post": _op("test_connection_table",
                            "validate a connection-table spec",
                            body=CONNECTION_TABLE)},
            "/api/v1/udfs": {
                "post": _op("create_udf", "compile/register a UDF", body=UDF),
                "get": _op("list_udfs", "list registered UDFs")},
            "/api/v1/udfs/{name}": {
                "delete": _op("delete_udf", "drop a UDF", ["name"])},
            "/api/v1/nodes/register": {
                "post": _op("register_node", "node daemon registration", body=NODE)},
            "/api/v1/nodes/{node_id}/heartbeat": {
                "post": _op("node_heartbeat", "node liveness beat", ["node_id"])},
            "/api/v1/nodes": {
                "get": _op("list_nodes", "registered node daemons")},
        },
    }
