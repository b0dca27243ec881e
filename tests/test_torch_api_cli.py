"""The port's REST API, OpenAPI spec and CLIs held to the JAX package's: the
same spec; every route answering the same scripted session with the same
status and body keys; `top`, `logs`, `trace` and `explain` printing the
same text from one controller database, whichever package wrote it;
`visualize` printing the same dot; and the mirrors of
tests/test_openapi.py, test_evolve.py, test_obs.py's controller-DB views
and test_observability.py's admin server through the port."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from test_torch_controller import port, port_mirror, run_mirrored, smoke_sql  # noqa: F401

# ------------------------------------------------------------------ mirrors

MIRRORS = {
    "test_openapi": lambda n: True,
    "test_evolve": lambda n: True,
    "test_obs": lambda n: n in ("test_top_and_trace_from_controller_db",
                                "test_top_header_renders_evolving_state"),
    "test_observability": lambda n: n in ("test_admin_server", "test_init_logging_formats",
                                          "test_admin_debug_endpoints"),
}
# test_evolve's engine-level cases build through tests/test_smoke.py's
# helper, the JAX package's engine: the port's helper of the same signature
# (tests/test_torch_sql_smoke_a.py) stands in
SUBS = {"test_evolve": {
    "from test_smoke import assert_outputs, build, canon, load_sql, read_output":
    "from test_smoke import assert_outputs, canon, load_sql, read_output\n"
    "from test_torch_sql_smoke_a import build"}}
MODS = {m: port_mirror(m, SUBS.get(m)) for m in MIRRORS}
CASES = [(m, n) for m, keep in MIRRORS.items() for n in sorted(dir(MODS[m]))
         if n.startswith("test_") and keep(n)]


def test_mirrored_cases_are_those_expected():
    assert len(CASES) == 7 + 9 + 2 + 3, CASES


@pytest.mark.parametrize("module,name", CASES)
def test_scenario_through_the_port(module, name, tmp_path, port, capsys):
    run_mirrored(MODS[module], name, tmp_path=tmp_path, _storage=port, capsys=capsys)


def test_auth_token_gates_mutations_and_the_client_carries_it(port):
    """test_openapi.py's auth case without the node daemon: mutations need
    the bearer token, reads stay open, the typed client sends it."""
    from arroyo_tpu_torch.api import ApiServer
    from arroyo_tpu_torch.api.client import ArroyoClient
    from arroyo_tpu_torch.controller import Database

    tcfg.update({"api.auth-token": "s3cret"})
    api = ApiServer(Database(), port=0).start()
    base = f"http://127.0.0.1:{api.port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/api/v1/pipelines/validate", data=b'{"query": "x"}', method="POST",
                headers={"Content-Type": "application/json"}))
        assert ei.value.code == 401
        with urllib.request.urlopen(f"{base}/api/v1/ping") as r:
            assert json.loads(r.read())["pong"]
        assert ArroyoClient(base).validate_query("SELEC nope")["valid"] is False
    finally:
        api.stop()


# ------------------------------------------------------------- REST session


def session(pkg: str, tmp_path) -> dict:
    """One scripted session against the package's ApiServer (no controller:
    the job stays Created): route label -> (status, body)."""
    if pkg == "jax":
        from arroyo_tpu.api import ApiServer
        from arroyo_tpu.controller import Database
    else:
        from arroyo_tpu_torch.api import ApiServer
        from arroyo_tpu_torch.controller import Database
    api = ApiServer(Database(), port=0).start()
    base = f"http://127.0.0.1:{api.port}"
    out: dict = {}

    def call(label, method, path, body=None):
        req = urllib.request.Request(
            base + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                status, raw = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read()
        try:
            payload = json.loads(raw)
        except ValueError:
            payload = raw
        out[label] = (status, payload)
        return payload

    sql, _ = smoke_sql(tmp_path, tag=f"rest-{pkg}")
    try:
        call("webui", "GET", "/")
        call("webui_asset", "GET", "/webui/app.js")
        call("webui_missing", "GET", "/webui/nope.js")
        call("openapi", "GET", "/api/v1/openapi.json")
        call("ping", "GET", "/api/v1/ping")
        call("validate_bad", "POST", "/api/v1/pipelines/validate", {"query": "SELEC nope"})
        call("validate_ok", "POST", "/api/v1/pipelines/validate", {"query": sql})
        call("create_pipeline_bad", "POST", "/api/v1/pipelines", {"name": "x"})
        created = call("create_pipeline", "POST", "/api/v1/pipelines",
                       {"name": "agg", "query": sql, "parallelism": 2})
        pid, jid = created["id"], created["job_id"]
        call("list_pipelines", "GET", "/api/v1/pipelines")
        call("get_pipeline", "GET", f"/api/v1/pipelines/{pid}")
        call("get_pipeline_missing", "GET", "/api/v1/pipelines/nope")
        call("pipeline_jobs", "GET", f"/api/v1/pipelines/{pid}/jobs")
        call("pipeline_graph", "GET", f"/api/v1/pipelines/{pid}/graph")
        call("evolve_not_running", "POST", f"/api/v1/pipelines/{pid}/evolve", {"query": sql})
        call("list_jobs", "GET", "/api/v1/jobs")
        call("get_job", "GET", f"/api/v1/jobs/{jid}")
        call("get_job_missing", "GET", "/api/v1/jobs/nope")
        for sub in ("checkpoints", "output", "metrics", "profile", "traces", "events",
                    "health", "fsck"):
            call(f"job_{sub}", "GET", f"/api/v1/jobs/{jid}/{sub}")
        call("patch_job_parallelism", "PATCH", f"/api/v1/jobs/{jid}", {"parallelism": 3})
        call("patch_job_stop", "PATCH", f"/api/v1/jobs/{jid}", {"stop": "immediate"})
        call("fleet", "GET", "/api/v1/fleet")
        call("connectors", "GET", "/api/v1/connectors")
        prof = call("create_profile", "POST", "/api/v1/connection_profiles",
                    {"name": "p", "connector": "impulse", "config": {"event_rate": 5}})
        call("create_profile_dup", "POST", "/api/v1/connection_profiles",
             {"name": "p", "connector": "impulse"})
        call("list_profiles", "GET", "/api/v1/connection_profiles")
        table = {"name": "imp", "connector": "impulse", "table_type": "source",
                 "profile_id": prof["id"], "config": {"message_count": 5}}
        call("test_table", "POST", "/api/v1/connection_tables/test", table)
        call("test_table_bad", "POST", "/api/v1/connection_tables/test",
             {"name": "x", "connector": "nope"})
        tab = call("create_table", "POST", "/api/v1/connection_tables", table)
        call("list_tables", "GET", "/api/v1/connection_tables")
        call("delete_profile_in_use", "DELETE", f"/api/v1/connection_profiles/{prof['id']}")
        call("delete_table", "DELETE", f"/api/v1/connection_tables/{tab['id']}")
        call("delete_profile", "DELETE", f"/api/v1/connection_profiles/{prof['id']}")
        call("register_node", "POST", "/api/v1/nodes/register",
             {"node_id": "n1", "addr": "http://127.0.0.1:1", "slots": 4})
        call("node_heartbeat", "POST", "/api/v1/nodes/n1/heartbeat", {})
        call("node_heartbeat_unknown", "POST", "/api/v1/nodes/zz/heartbeat", {})
        call("list_nodes", "GET", "/api/v1/nodes")
        call("create_udf", "POST", "/api/v1/udfs",
             {"name": "plus_one", "language": "python", "return_dtype": "int64",
              "arg_dtypes": ["int64"],
              "source": "from arroyo_tpu_torch.udf import register_udf\n"
                        "register_udf('plus_one', lambda x: x + 1, return_dtype='int64')\n"
              if pkg == "port" else
              "from arroyo_tpu.udf import register_udf\n"
              "register_udf('plus_one', lambda x: x + 1, return_dtype='int64')\n"})
        call("create_udf_bad", "POST", "/api/v1/udfs", {"name": "x"})
        call("list_udfs", "GET", "/api/v1/udfs")
        call("delete_udf", "DELETE", "/api/v1/udfs/plus_one")
        call("delete_pipeline", "DELETE", f"/api/v1/pipelines/{pid}")
        call("unknown_route", "GET", "/api/v1/nope")
    finally:
        api.stop()
    return out


def shape(x, depth: int = 0):
    """A body's keys, and its list items' keys, two levels down."""
    if isinstance(x, dict):
        return {k: shape(v, depth + 1) if depth < 2 else None for k, v in sorted(x.items())}
    if isinstance(x, list):
        return [shape(x[0], depth + 1)] if x and depth < 2 else []
    return type(x).__name__ if depth < 3 else None


_SESSIONS: dict = {}
ROUTES = ["webui", "webui_asset", "webui_missing", "openapi", "ping", "validate_bad",
          "validate_ok", "create_pipeline_bad", "create_pipeline", "list_pipelines",
          "get_pipeline", "get_pipeline_missing", "pipeline_jobs", "pipeline_graph",
          "evolve_not_running", "list_jobs", "get_job", "get_job_missing", "job_checkpoints",
          "job_output", "job_metrics", "job_profile", "job_traces", "job_events", "job_health",
          "job_fsck", "patch_job_parallelism", "patch_job_stop", "fleet", "connectors",
          "create_profile", "create_profile_dup", "list_profiles", "test_table",
          "test_table_bad", "create_table", "list_tables", "delete_profile_in_use",
          "delete_table", "delete_profile", "register_node", "node_heartbeat",
          "node_heartbeat_unknown", "list_nodes", "create_udf", "create_udf_bad", "list_udfs",
          "delete_udf", "delete_pipeline", "unknown_route"]


@pytest.mark.parametrize("route", ROUTES)
def test_rest_route_answers_as_jax(route, tmp_path, port):
    if not _SESSIONS:
        _SESSIONS.update(jax=session("jax", tmp_path), port=session("port", tmp_path))
    (js, jb), (ts, tb) = _SESSIONS["jax"][route], _SESSIONS["port"][route]
    assert ts == js, (route, tb, jb)
    if route in ("webui", "webui_asset", "openapi"):
        assert tb == jb  # the port's own copy of the console and the same spec
    elif route == "pipeline_graph":
        assert [n["id"] for n in tb["nodes"]] == [n["id"] for n in jb["nodes"]]
        assert tb["edges"] == jb["edges"]
    else:
        assert shape(tb) == shape(jb), route


def test_session_covers_every_route():
    from arroyo_tpu_torch.api.server import ApiServer

    handlers = {h for _m, _p, h in ApiServer._ROUTES}
    assert len(handlers) == 38 and len(ROUTES) >= len(handlers)


def test_openapi_spec_equals_jax():
    from arroyo_tpu.api.openapi import spec as jspec
    from arroyo_tpu_torch.api.openapi import spec as tspec

    assert tspec() == jspec()


def test_cpp_udf_is_built_and_a_bad_source_is_rejected_with_gpps_log(port, tmp_path):
    """POST /api/v1/udfs with C++ source builds it (the artifact under
    ``compiler.artifacts-url``) and registers it; a source g++ refuses
    answers 400 with g++'s log and stays out of the database."""
    from arroyo_tpu_torch.api import ApiServer
    from arroyo_tpu_torch.controller import Database
    from arroyo_tpu_torch.udf import drop_udf, lookup_udf

    tcfg.update({"compiler.artifacts-url": str(tmp_path / "artifacts")})
    db = Database()
    api = ApiServer(db, port=0).start()

    def post(body):
        return urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{api.port}/api/v1/udfs", method="POST",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}))

    try:
        with post({"name": "twice", "language": "cpp", "arg_dtypes": ["int64"],
                   "return_dtype": "int64",
                   "source": '#include <cstdint>\nextern "C" void twice(int64_t n, '
                             'const int64_t* a, int64_t* o) { for (int64_t i = 0; i < n; i++) '
                             'o[i] = 2 * a[i]; }'}) as r:
            out = json.loads(r.read())
        assert out["artifact_url"].startswith(str(tmp_path / "artifacts"))
        assert list(lookup_udf("twice").fn(np.arange(3, dtype=np.int64))) == [0, 2, 4]
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"name": "c", "language": "cpp", "source": "this is not C++"})
        assert ei.value.code == 400
        assert "g++ failed" in json.loads(ei.value.read())["error"]
        assert [u["name"] for u in db.list_udfs()] == ["twice"]
    finally:
        api.stop()
        drop_udf("twice")


# ------------------------------------------------------------ CLI text


def finished_job_db(writer: str, tmp_path) -> tuple:
    """A file database holding one finished two-subtask job (metrics,
    profile, traces, events, checkpoints), written by ``writer``'s
    controller."""
    import time

    from arroyo_tpu import config as jcfg

    if writer == "jax":
        from arroyo_tpu.controller import ControllerServer, Database
        from arroyo_tpu.controller.scheduler import EmbeddedScheduler
    else:
        from arroyo_tpu_torch.controller import ControllerServer, Database
        from arroyo_tpu_torch.controller.scheduler import EmbeddedScheduler
    for c in (jcfg, tcfg):
        c.update({"checkpoint.interval-ms": 100, "testing.source-read-delay-micros": 2000})
    path = str(tmp_path / f"{writer}.db")
    sql, _ = smoke_sql(tmp_path, tag=f"cli-{writer}")
    db = Database(path)
    ctl = ControllerServer(db, EmbeddedScheduler()).start()
    try:
        jid = db.create_job(db.create_pipeline("agg", sql, 2))
        assert ctl.wait_for_state(jid, "Finished", timeout=120) == "Finished"
        deadline = time.monotonic() + 10
        while not (db.list_traces(jid) and db.get_profile(jid)) and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        ctl.stop()
        db.close()
    return path, jid


CLI_COMMANDS = {
    "top": lambda jid, db: ["top", jid, "--db", db, "--once"],
    "logs": lambda jid, db: ["logs", jid, "--db", db],
    "trace_report": lambda jid, db: ["trace", jid, "--db", db, "--report"],
    "trace_json": lambda jid, db: ["trace", jid, "--db", db],
    "explain": lambda jid, db: ["explain", jid, "--db", db],
    "top_unknown": lambda jid, db: ["top", "nope", "--db", db, "--once"],
}
_DBS: dict = {}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("command", sorted(CLI_COMMANDS))
def test_cli_prints_what_jax_prints_from_one_database(command, writer, tmp_path, port, capsys):
    from arroyo_tpu import cli as jcli
    from arroyo_tpu_torch import cli as tcli

    if writer not in _DBS:
        _DBS[writer] = finished_job_db(writer, tmp_path)
    path, jid = _DBS[writer]
    argv = CLI_COMMANDS[command](jid, path)
    outs = []
    for cli in (jcli, tcli):
        rc = cli.main(list(argv))
        got = capsys.readouterr()
        outs.append((rc, got.out, got.err))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("name", ["grouped_aggregates", "windowed_inner_join", "union_all",
                                  "updating_aggregate", "nexmark_q5"])
def test_visualize_prints_the_jax_dot(name, tmp_path, capsys):
    from arroyo_tpu import cli as jcli
    from arroyo_tpu_torch import cli as tcli

    sql, _ = smoke_sql(tmp_path, name)
    path = tmp_path / f"{name}.sql"
    path.write_text(sql)
    assert jcli.main(["visualize", str(path)]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["visualize", str(path)]) == 0
    assert capsys.readouterr().out == want and "digraph" in want
