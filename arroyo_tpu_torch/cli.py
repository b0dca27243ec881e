"""CLI: the single-binary entry point (the port's copy of
arroyo_tpu/cli.py). `python -m arroyo_tpu_torch <cmd>`.

Reference: crates/arroyo/src/main.rs:83-123 (clap subcommands run / api /
cluster / worker / visualize). The port's subcommands take the JAX
package's arguments and give its exit codes. Every entry point runs on the
card unless the port's config names the CPU
(``ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE=cpu``).

  run <file.sql>      embedded cluster: api + controller + worker in-process,
                      ^C checkpoints then stops (reference run.rs:84-118)
  cluster             api + controller, jobs submitted over REST
  api                 REST API only (external controller polls the same DB)
  worker ...          subprocess entry used by the process scheduler
  node                per-machine daemon: registers with the cluster API and
                      spawns the workers the node scheduler places here
  compile-service     builds C++ UDFs with g++ and publishes the artifacts
  visualize <file.sql> print the dataflow graph as graphviz dot
  check <file.sql>    plan the SQL and run every analyzer pass without
                      running it (--json / --sarif); exit 1 if rejected
  lint [paths]        repo lint and the replay-soundness, trace-safety and
                      concurrency audits over the package (--json /
                      --sarif); exit 1 on any unwaived finding
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Optional


def _cmd_check(args) -> int:
    """Static analysis of a pipeline without running it: plan the SQL, run
    every analyzer pass (arroyo_tpu_torch.analysis), print the full
    diagnostic report (--json: a machine-readable array for CI annotation).
    Exit 0 = clean (warnings allowed unless --strict), 1 = rejected."""
    import arroyo_tpu_torch
    from arroyo_tpu_torch.analysis import (Severity, check_sql, render_json,
                                           render_report, render_sarif)

    arroyo_tpu_torch._load_operators()
    with open(args.sql_file) as f:
        sql = f.read()
    pp, diags = check_sql(sql, parallelism=args.parallelism)
    if args.sarif:
        print(render_sarif(diags))
    elif args.json:
        print(render_json(diags))
    elif diags:
        print(render_report(diags))
    if any(d.severity == Severity.ERROR for d in diags) or pp is None:
        return 1
    if not diags and not args.json and not args.sarif:
        print(f"ok: {len(pp.graph.nodes)} nodes, {len(pp.graph.edges)} edges, "
              "no findings")
    if args.strict and diags:
        return 1
    return 0


def _cmd_lint(args) -> int:
    """Repo lint and the LR2xx-LR4xx audits: AST checks over the port's own
    invariants (arroyo_tpu_torch.analysis.repo_lint; --json: a
    machine-readable array for CI annotation). Exit 1 on any unwaived
    finding."""
    import arroyo_tpu_torch
    from arroyo_tpu_torch.analysis import (lint_paths, render_json, render_report,
                                           render_sarif)

    pkg_dir = os.path.dirname(os.path.abspath(arroyo_tpu_torch.__file__))
    root = os.path.dirname(pkg_dir)
    diags = lint_paths(args.paths or [pkg_dir], root=root)
    if args.sarif:
        print(render_sarif(diags))
        return 1 if diags else 0
    if args.json:
        print(render_json(diags))
        return 1 if diags else 0
    if diags:
        print(render_report(diags))
        return 1
    print("lint clean")
    return 0


def _cmd_node(args) -> int:
    """Per-machine node daemon: registers with the cluster API and launches
    the worker processes the controller places here (each takes CUDA unless
    the port's config names another device)."""
    import arroyo_tpu_torch
    from arroyo_tpu_torch.controller.node import NodeServer

    arroyo_tpu_torch._load_operators()
    node = NodeServer(args.controller, slots=args.slots, port=args.port,
                      host=args.host, advertise_host=args.advertise_host).start()
    print(f"node {node.node_id} on :{node.port} -> {args.controller}", file=sys.stderr,
          flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        node.stop()
        return 0


def _cmd_compile_service(args) -> int:
    """Standalone UDF compile service: builds cpp UDF sources into shared
    libraries and publishes them to the artifact store; the API delegates
    here when ``compiler.endpoint`` is configured."""
    from arroyo_tpu_torch.compiler import CompileServer

    srv = CompileServer(host=args.host, port=args.port,
                        artifacts_url=args.artifacts_url).start()
    print(f"compile service on :{srv.port} -> {srv.service.artifacts_url}",
          file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()
        return 0


def _cmd_visualize(args) -> int:
    import arroyo_tpu_torch
    from arroyo_tpu_torch.sql import plan_query

    arroyo_tpu_torch._load_operators()
    with open(args.sql_file) as f:
        pp = plan_query(f.read())
    print(pp.graph.dot())
    return 0


def _cmd_evolve(args) -> int:
    """Live pipeline evolution (versioned redeploy): POST the evolved SQL to
    /api/v1/pipelines/<id>/evolve, print the per-node plan-diff classification
    (carried / rebuilt / stateless / dropped), and exit 0 once the controller
    has accepted the drain + blue/green cutover. An incompatible change is
    rejected server-side with AR-series diagnostics and exits 1 — the running
    job is never touched."""
    from arroyo_tpu_torch.api.client import ApiError, ArroyoClient

    with open(args.sql_file) as f:
        query = f.read()
    client = ArroyoClient(args.api)

    def render(payload: dict) -> None:
        cls = payload.get("classifications") or []
        if cls:
            width = max(len(c.get("node_id", "")) for c in cls)
            for c in cls:
                line = f"  {c.get('node_id', ''):<{width}}  {c.get('action', '')}"
                if c.get("from"):
                    line += f"  (from {c['from']})"
                if c.get("detail"):
                    line += f"  -- {c['detail']}"
                print(line)
        for d in payload.get("diagnostics") or []:
            print(f"  {d.get('severity')} {d.get('rule')}: {d.get('message')}")
            if d.get("hint"):
                print(f"    hint: {d['hint']}")

    try:
        resp = client.evolve_pipeline(args.pipeline_id, query)
    except ApiError as e:
        payload = e.payload if isinstance(e.payload, dict) else {}
        print(payload.get("error") or f"evolve failed: {e}", file=sys.stderr)
        render(payload)
        return 1
    if resp.get("noop"):
        print(f"pipeline {args.pipeline_id}: query unchanged, nothing to do")
        return 0
    print(f"evolution accepted: pipeline {args.pipeline_id} -> "
          f"version {resp.get('version')} (job {resp.get('job_id')})")
    render(resp)
    return 0


def _cmd_fsck(args) -> int:
    """Offline checkpoint-chain verifier (disaster-recovery fsck): walk every
    epoch of the job under the checkpoint store — marker completeness and
    checksum, sidecar and table-file envelopes, spill-run liveness and
    footers, evolution-mapping pairing, orphans — and print the shared
    diagnostic report (--json / --sarif for CI). Exit 0 = the chain is
    restorable (warnings allowed), 1 = at least one artifact is corrupt,
    torn, or missing (FS-series ERROR)."""
    from arroyo_tpu_torch.analysis import (Severity, render_json, render_report,
                                     render_sarif)
    from arroyo_tpu_torch.config import config
    from arroyo_tpu_torch.state.integrity import fsck_job

    storage_url = args.storage_url or str(config().get("checkpoint.storage-url"))
    diags = fsck_job(storage_url, args.job_id)
    if args.sarif:
        print(render_sarif(diags))
    elif args.json:
        print(render_json(diags))
    elif diags:
        print(render_report(diags))
    if any(d.severity == Severity.ERROR for d in diags):
        return 1
    if not diags and not args.json and not args.sarif:
        print(f"fsck clean: job {args.job_id} checkpoint chain verified")
    return 0


def _cmd_run(args) -> int:
    import arroyo_tpu_torch
    from arroyo_tpu_torch.api import ApiServer
    from arroyo_tpu_torch.controller import ControllerServer, Database
    from arroyo_tpu_torch.controller.scheduler import scheduler_for

    arroyo_tpu_torch._load_operators()
    with open(args.sql_file) as f:
        sql = f.read()
    # plan (and static-analyze) up front: a rejected pipeline prints its
    # diagnostics here instead of spinning up a cluster that dies "Failed"
    from arroyo_tpu_torch.sql import plan_query
    from arroyo_tpu_torch.sql.lexer import SqlError

    try:
        plan_query(sql)
    except SqlError as e:
        print(f"pipeline rejected at plan time:\n{e}", file=sys.stderr)
        return 2
    db = Database(args.db or ":memory:")
    api = ApiServer(db, port=args.api_port).start()
    controller = ControllerServer(db, scheduler_for(args.scheduler, db)).start()
    pid = db.create_pipeline(os.path.basename(args.sql_file), sql, args.parallelism)
    jid = db.create_job(pid)
    print(f"pipeline {pid} job {jid} (api on :{api.port})", file=sys.stderr)

    stopping = threading.Event()

    def on_sigint(_sig, _frm):
        if stopping.is_set():
            os._exit(130)
        stopping.set()
        print("stopping with a final checkpoint (^C again to force)", file=sys.stderr)
        db.update_job(jid, desired_stop="checkpoint")

    signal.signal(signal.SIGINT, on_sigint)
    try:
        state = controller.wait_for_state(
            jid, "Finished", "Stopped", "Failed", timeout=args.timeout
        )
        print(f"job {jid}: {state}", file=sys.stderr)
        return 0 if state in ("Finished", "Stopped") else 1
    finally:
        controller.stop()
        api.stop()


def _api_port(args) -> int:
    """``--api-port``, else the config's ``api.http-port`` (5115)."""
    from arroyo_tpu_torch.config import config as _cfg

    return args.api_port if args.api_port is not None else int(_cfg().get("api.http-port"))


def _cmd_cluster(args) -> int:
    import arroyo_tpu_torch
    from arroyo_tpu_torch.api import ApiServer
    from arroyo_tpu_torch.controller import ControllerServer, Database
    from arroyo_tpu_torch.controller.scheduler import scheduler_for
    from arroyo_tpu_torch.server_common import AdminServer, init_logging

    init_logging()
    arroyo_tpu_torch._load_operators()
    from arroyo_tpu_torch.config import config as _cfg

    AdminServer("cluster", port=_cfg().get("admin.http-port", 0)).start()
    db = Database(args.db or ":memory:")
    api = ApiServer(db, port=_api_port(args)).start()
    controller = ControllerServer(db, scheduler_for(args.scheduler, db)).start()
    print(f"cluster up: api on :{api.port}", file=sys.stderr)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        controller.stop()
        api.stop()
        return 0


def _cmd_api(args) -> int:
    from arroyo_tpu_torch.api import ApiServer
    from arroyo_tpu_torch.controller import Database

    db = Database(args.db or ":memory:")
    api = ApiServer(db, port=_api_port(args)).start()
    print(f"api on :{api.port}", file=sys.stderr)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        api.stop()
        return 0


def _cmd_worker(args) -> int:
    """Worker subprocess (reference `arroyo worker` spawned by the process
    scheduler): runs the engine, speaks the JSON-lines protocol on
    stdin/stdout (scheduler.py docstring)."""
    import arroyo_tpu_torch
    from arroyo_tpu_torch.engine.engine import Engine
    from arroyo_tpu_torch.sql import plan_query
    from arroyo_tpu_torch.sql.planner import set_parallelism

    arroyo_tpu_torch._load_operators()
    from arroyo_tpu_torch.server_common import AdminServer

    # per-worker admin endpoint on an ephemeral port (reference: every
    # service runs one, arroyo-server-common lib.rs:280)
    AdminServer("worker", port=0).start()

    def emit(obj: dict) -> None:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    if getattr(args, "udfs_file", None):
        from arroyo_tpu_torch.compiler import activate_udf_specs

        with open(args.udfs_file) as f:
            activate_udf_specs(json.load(f))
    if not getattr(args, "graph_file", None) and not getattr(args, "sql_file", None):
        print("worker: one of --sql-file / --graph-file is required", file=sys.stderr)
        return 2
    if getattr(args, "graph_file", None):
        # pre-planned IR shipped by the control plane: no local re-planning
        from arroyo_tpu_torch.graph import Graph

        with open(args.graph_file) as f:
            graph = Graph.loads(f.read())
    else:
        with open(args.sql_file) as f:
            sql = f.read()
        pp = plan_query(sql)
        if args.parallelism > 1:
            set_parallelism(pp.graph, args.parallelism)
        graph = pp.graph
    n_workers = int(getattr(args, "n_workers", None) or 1)
    network = None
    assignment = None
    started = threading.Event()
    if n_workers > 1:
        # one worker of a multi-worker set: bind the data plane now (the
        # port rides the "started" event), hold task startup until the
        # controller distributes the full peer table
        from arroyo_tpu_torch.engine.network import NetworkManager

        with open(args.assignment_file) as f:
            assignment = {(nid, int(sub)): int(w) for nid, sub, w in json.load(f)}
        network = NetworkManager(host=args.dp_bind or "127.0.0.1")
    eng = Engine(
        graph, job_id=args.job_id,
        restore_epoch=args.restore_epoch,
        storage_url=args.storage_url or None,
        assignment=assignment,
        worker_index=int(getattr(args, "worker_index", None) or 0),
        network=network,
    )
    # relay epoch-lifecycle spans AND structured job events to the
    # controller so ITS recorders (behind /traces, /events, and the wedge
    # diagnostics) hold this worker's timelines and event feed too
    eng.relay_obs = True
    if n_workers > 1:
        emit({"event": "started", "dp_port": network.port,
              "worker_index": int(args.worker_index or 0)})
    else:
        eng.start()
        started.set()
        emit({"event": "started"})
    fatal: list[str] = []

    def read_commands() -> None:
        import traceback as _tb

        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                cmd = json.loads(line)
            except json.JSONDecodeError:
                continue
            if cmd.get("cmd") == "checkpoint":
                eng.trigger_checkpoint(int(cmd["epoch"]), then_stop=bool(cmd.get("then_stop")))
            elif cmd.get("cmd") == "stop":
                eng.stop()
            elif cmd.get("cmd") == "commit":
                # phase 2 of the controller's 2PC: the epoch's job-level
                # metadata is durable across ALL workers
                eng.deliver_commit(int(cmd["epoch"]))
            elif cmd.get("cmd") == "peers" and network is not None:
                network.set_peers({
                    int(k): (v[0], int(v[1]))
                    for k, v in (cmd.get("peers") or {}).items()
                })
                if not started.is_set():
                    try:
                        eng.start()
                    except Exception:  # noqa: BLE001 - surface as a failed event
                        # a build/restore error here would otherwise die with
                        # this thread while the main loop keeps heartbeating —
                        # an invisible wedge the controller can't diagnose
                        fatal.append(_tb.format_exc())
                        return
                    started.set()

    threading.Thread(target=read_commands, daemon=True).start()
    from arroyo_tpu_torch.connectors.preview import take_preview_rows

    last_hb = 0.0
    while True:
        with eng._lock:
            done = (started.is_set() and eng._n_tasks
                    and len(eng._finished_tasks) + len(eng._failed) >= eng._n_tasks)
            failed = list(eng._failed)
        send_hb = time.monotonic() - last_hb > 1.0
        if send_hb:
            # chaos hook: dropping heartbeats (worker.heartbeat:drop) models
            # a hung-but-not-dead worker; the controller's heartbeat-timeout
            # detection must declare it lost and recover (metrics ride the
            # same cadence, so a "hung" worker goes silent on both)
            from arroyo_tpu_torch.faults import fault_point

            last_hb = time.monotonic()
            if (fault_point("worker.heartbeat") or (None,))[0] == "drop":
                send_hb = False
        # ONE drain for every relay stream — spans, job events, throttled
        # metrics, coordinator acks / completed epochs. The ordering rules
        # (spans and events strictly before coordinator acks) live in
        # Engine.drain_relay, not in per-stream loops here.
        for ev in eng.drain_relay(include_metrics=send_hb):
            emit(ev)
        if send_hb:
            emit({"event": "heartbeat"})
        lines = take_preview_rows(args.job_id)
        if lines:
            emit({"event": "sink_data", "lines": lines})
        if fatal:
            emit({"event": "failed", "error": fatal[0][-2000:]})
            return 1
        if failed:
            emit({"event": "failed", "error": failed[0].error or "task failed"})
            return 1
        if done:
            emit({"event": "finished"})
            return 0
        time.sleep(0.05)


def _cmd_trace(args) -> int:
    """Export a job's epoch-lifecycle traces (obs.trace): Chrome
    trace-event JSON (open in chrome://tracing or Perfetto's legacy-UI
    importer) or, with --report, human-readable per-epoch timelines naming
    any stuck subtask. Reads the controller DB directly (--db) or the
    cluster API (--api)."""
    import urllib.request

    from arroyo_tpu_torch.obs import trace as obs_trace

    job_events: list = []
    if args.db:
        from arroyo_tpu_torch.controller import Database

        db = Database(args.db)
        rows = db.list_traces(args.job_id, epoch=args.epoch)
        by_epoch = {r["epoch"]: r["events"] for r in rows}
        job_events = db.list_events(args.job_id)
    else:
        url = (f"{args.api.rstrip('/')}/api/v1/jobs/{args.job_id}"
               "/traces?format=events")
        if args.epoch is not None:
            url += f"&epoch={args.epoch}"
        with urllib.request.urlopen(url, timeout=10) as r:
            payload = json.load(r)
        by_epoch = {int(e): evs
                    for e, evs in (payload.get("epochs") or {}).items()}
        try:
            with urllib.request.urlopen(
                    f"{args.api.rstrip('/')}/api/v1/jobs/{args.job_id}"
                    "/events", timeout=10) as r:
                job_events = json.load(r).get("data") or []
        except OSError:
            job_events = []
    if not by_epoch:
        print(f"no trace events recorded for job {args.job_id}",
              file=sys.stderr)
        return 1
    if args.report:
        for e in sorted(by_epoch):
            print(obs_trace.timeline_report(args.job_id, e, by_epoch[e]))
        return 0
    chrome = obs_trace.chrome_trace(args.job_id, by_epoch,
                                    job_events=job_events)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(chrome, f)
        print(f"wrote {len(chrome['traceEvents'])} trace events to "
              f"{args.out}", file=sys.stderr)
    else:
        print(json.dumps(chrome))
    return 0


def _cmd_logs(args) -> int:
    """Per-job structured event feed (obs.events): operator panics, set
    restores, wedged epochs, commit re-deliveries, rescales, and health
    transitions, each with its {node, subtask, worker, epoch} scope. Reads
    the controller DB directly (--db) or the cluster API; --follow tails
    new events until the job reaches a terminal state."""
    import urllib.error
    import urllib.request

    from arroyo_tpu_torch.obs.events import render_event

    db = None
    if args.db:
        from arroyo_tpu_torch.controller import Database

        db = Database(args.db)

    # state is the job's FSM state, "missing" for a job id the DB/API does
    # not know (so --follow can error out instead of tailing a typo
    # forever), or None when the API state probe transiently failed
    def fetch(after_seq: int) -> tuple[list[dict], Optional[str]]:
        if db is not None:
            job = db.get_job(args.job_id)
            return (db.list_events(args.job_id, level=args.level,
                                   after_seq=after_seq),
                    job["state"] if job else "missing")
        base = args.api.rstrip("/")
        url = f"{base}/api/v1/jobs/{args.job_id}/events?after={after_seq}"
        if args.level:
            url += f"&level={args.level}"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                payload = json.load(r)
        except OSError:
            if not args.follow:
                raise  # one-shot read: surface the API failure
            return [], None  # tailing: keep polling through the blip
        try:
            with urllib.request.urlopen(
                    f"{base}/api/v1/jobs/{args.job_id}", timeout=10) as r:
                state = json.load(r).get("state")
        except urllib.error.HTTPError as e:
            state = "missing" if e.code == 404 else None
        except OSError:
            state = None
        return payload.get("data") or [], state

    last_seq = 0
    printed = 0
    while True:
        events, state = fetch(last_seq)
        for ev in events:
            print(render_event(ev))
            last_seq = max(last_seq, int(ev.get("seq") or 0))
            printed += 1
        if state == "missing" and not printed:
            print(f"no such job {args.job_id}", file=sys.stderr)
            return 1
        if not args.follow:
            if not printed:
                print(f"no events recorded for job {args.job_id}",
                      file=sys.stderr)
                return 1
            return 0
        if state in ("Failed", "Finished", "Stopped", "missing"):
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def _cmd_explain(args) -> int:
    """EXPLAIN ANALYZE for a job: render the logical plan sink-first,
    annotated with the live runtime cost profile (per-operator busy%,
    rows/s, self-time by category, state rows/bytes, top-k hot keys,
    late-row drops) merged across every worker of the set. Reads the
    controller DB directly (--db) or the cluster API (--api)."""
    import urllib.error
    import urllib.request

    from arroyo_tpu_torch.obs.profile import job_profile, render_explain

    def plan_nodes_edges(sql, parallelism):
        """Plan the pipeline the way the engine runs it (the shared
        executed_graph_view: parallelism + chaining applied) so plan node
        ids line up with runtime metrics; a plan failure (e.g.
        unregistered UDFs) degrades to a plain per-operator profile
        listing instead of erroring out."""
        try:
            import arroyo_tpu_torch
            from arroyo_tpu_torch.sql.planner import executed_graph_view

            arroyo_tpu_torch._load_operators()
            return executed_graph_view(sql, parallelism)
        except Exception:  # noqa: BLE001 - plan is decoration, profile is data
            return [], []

    if args.db:
        from arroyo_tpu_torch.controller import Database

        db = Database(args.db)
        job = db.get_job(args.job_id)
        if job is None:
            print(f"job {args.job_id} not found", file=sys.stderr)
            return 1
        profile = (db.get_profile(args.job_id)
                   or job_profile(db.get_metrics(args.job_id)))
        pipeline = db.get_pipeline(job["pipeline_id"]) or {}
        nodes, edges = plan_nodes_edges(
            pipeline.get("query", ""), int(pipeline.get("parallelism") or 1))
    else:
        base = args.api.rstrip("/")

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return json.load(r)

        try:
            job = get(f"/api/v1/jobs/{args.job_id}")
        except urllib.error.HTTPError:
            print(f"job {args.job_id} not found", file=sys.stderr)
            return 1
        profile = get(f"/api/v1/jobs/{args.job_id}/profile").get("data") or {}
        nodes, edges = [], []
        try:
            g = get(f"/api/v1/pipelines/{job['pipeline_id']}/graph")
            nodes, edges = g.get("nodes", []), g.get("edges", [])
        except (urllib.error.HTTPError, urllib.error.URLError, KeyError):
            pass
    if not profile:
        print(f"no profile snapshot recorded yet for {args.job_id} "
              "(workers report ~1/s once running)", file=sys.stderr)
    print(render_explain(nodes, edges, profile or {}, job))
    return 0


def _cmd_top(args) -> int:
    """Live per-operator job view from the controller DB: rows/s in/out,
    backpressure, queue-transit p99, watermark lag, and the last epoch's
    duration with its dominant checkpoint phase. Refreshes until the job
    reaches a terminal state (--once prints a single frame)."""
    import urllib.error
    import urllib.request

    from arroyo_tpu_torch.obs import topview

    db = None
    if args.db:
        from arroyo_tpu_torch.controller import Database

        db = Database(args.db)

    def fetch():
        if db is not None:
            job = db.get_job(args.job_id)
            if job is None:
                return None, None, None
            if job.get("state") == "Queued":
                # admission-queue position from the controller's persisted
                # fleet snapshot (the API path attaches it server-side)
                pos = db.fleet_queue_position(args.job_id)
                if pos is not None:
                    job["queue_position"] = pos
            return (job, db.get_metrics(args.job_id),
                    db.list_checkpoints(args.job_id))
        base = args.api.rstrip("/")

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return json.load(r)

        try:
            job = get(f"/api/v1/jobs/{args.job_id}")
        except urllib.error.HTTPError:
            return None, None, None
        metrics = get(f"/api/v1/jobs/{args.job_id}/metrics").get("data")
        ckpts = get(f"/api/v1/jobs/{args.job_id}/checkpoints").get("data")
        return job, metrics, ckpts

    while True:
        job, metrics, ckpts = fetch()
        if job is None or "state" not in job:
            print(f"job {args.job_id} not found", file=sys.stderr)
            return 1
        frame = topview.render(job, metrics, ckpts)
        if args.once:
            print(frame)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        if job["state"] in ("Failed", "Finished", "Stopped"):
            return 0
        time.sleep(args.interval)


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="arroyo_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="run a SQL pipeline with an embedded cluster")
    rp.add_argument("sql_file")
    rp.add_argument("--parallelism", type=int, default=1)
    rp.add_argument("--scheduler", default="embedded", choices=["embedded", "process"])
    rp.add_argument("--api-port", type=int, default=0)
    rp.add_argument("--db", default=None)
    rp.add_argument("--timeout", type=float, default=86400)
    rp.set_defaults(fn=_cmd_run)

    cp = sub.add_parser("cluster", help="api + controller, submit jobs over REST")
    cp.add_argument("--scheduler", default="process",
                    choices=["embedded", "process", "node", "kubernetes"])
    cp.add_argument("--api-port", type=int, default=None,
                    help="default: the config's api.http-port (5115)")
    cp.add_argument("--db", default=None)
    cp.set_defaults(fn=_cmd_cluster)

    ap = sub.add_parser("api", help="REST API server only")
    ap.add_argument("--api-port", type=int, default=None,
                    help="default: the config's api.http-port (5115)")
    ap.add_argument("--db", default=None)
    ap.set_defaults(fn=_cmd_api)

    wp = sub.add_parser("worker", help="worker subprocess (used by process scheduler)")
    wp.add_argument("--sql-file", default=None)
    wp.add_argument("--graph-file", default=None)
    wp.add_argument("--job-id", required=True)
    wp.add_argument("--parallelism", type=int, default=1)
    wp.add_argument("--restore-epoch", type=int, default=None)
    wp.add_argument("--storage-url", default=None)
    wp.add_argument("--udfs-file", default=None)
    wp.add_argument("--worker-index", type=int, default=None,
                    help="this worker's index within a multi-worker set")
    wp.add_argument("--n-workers", type=int, default=1,
                    help="size of the job's worker set")
    wp.add_argument("--assignment-file", default=None,
                    help="JSON [[node_id, subtask, worker], ...] placement")
    wp.add_argument("--dp-bind", default=None,
                    help="bind host for the cross-worker data plane")

    np_ = sub.add_parser("node", help="per-machine worker launcher daemon")
    np_.add_argument("--controller", required=True,
                     help="cluster API base url, e.g. http://host:5115")
    np_.add_argument("--slots", type=int, default=16)
    np_.add_argument("--port", type=int, default=0)
    np_.add_argument("--host", default="0.0.0.0",
                     help="bind address for the node's HTTP surface")
    np_.add_argument("--advertise-host", default=None,
                     help="routable hostname the controller should dial "
                          "(default: the bind host)")
    np_.set_defaults(fn=_cmd_node)
    wp.set_defaults(fn=_cmd_worker)

    vp = sub.add_parser("visualize", help="print the dataflow graph as dot")
    vp.add_argument("sql_file")
    vp.set_defaults(fn=_cmd_visualize)

    tp = sub.add_parser("trace", help="export a job's checkpoint-epoch "
                                      "traces (Chrome trace-event JSON)")
    tp.add_argument("job_id")
    tp.add_argument("--api", default="http://127.0.0.1:5115",
                    help="cluster API base url")
    tp.add_argument("--db", default=None,
                    help="read the controller DB file directly instead")
    tp.add_argument("--epoch", type=int, default=None,
                    help="restrict to one epoch")
    tp.add_argument("--out", "-o", default=None,
                    help="write the JSON here instead of stdout")
    tp.add_argument("--report", action="store_true",
                    help="print human-readable per-epoch timelines instead")
    tp.set_defaults(fn=_cmd_trace)

    op = sub.add_parser("top", help="live per-operator job view "
                                    "(throughput, backpressure, watermark "
                                    "lag, checkpoint phases)")
    op.add_argument("job_id")
    op.add_argument("--api", default="http://127.0.0.1:5115",
                    help="cluster API base url")
    op.add_argument("--db", default=None,
                    help="read the controller DB file directly instead")
    op.add_argument("--interval", type=float, default=2.0,
                    help="refresh period seconds")
    op.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clearing)")
    op.set_defaults(fn=_cmd_top)

    lg = sub.add_parser("logs", help="structured job event feed (operator "
                                     "panics, restores, wedged epochs, "
                                     "health transitions)")
    lg.add_argument("job_id")
    lg.add_argument("--api", default="http://127.0.0.1:5115",
                    help="cluster API base url")
    lg.add_argument("--db", default=None,
                    help="read the controller DB file directly instead")
    lg.add_argument("--level", default=None,
                    choices=["DEBUG", "INFO", "WARN", "ERROR"],
                    help="minimum level to show")
    lg.add_argument("--follow", "-f", action="store_true",
                    help="keep tailing new events until the job ends")
    lg.add_argument("--interval", type=float, default=1.0,
                    help="--follow poll period seconds")
    lg.set_defaults(fn=_cmd_logs)

    ep = sub.add_parser("explain", help="EXPLAIN ANALYZE: the logical plan "
                                        "annotated with live per-operator "
                                        "busy%%, rows/s, state sizes, and "
                                        "hot keys")
    ep.add_argument("job_id")
    ep.add_argument("--api", default="http://127.0.0.1:5115",
                    help="cluster API base url")
    ep.add_argument("--db", default=None,
                    help="read the controller DB file directly instead")
    ep.set_defaults(fn=_cmd_explain)

    ev = sub.add_parser("evolve", help="live pipeline evolution: plan-diff "
                                       "the new SQL, carry proven state, "
                                       "blue/green cutover at a barrier")
    ev.add_argument("pipeline_id")
    ev.add_argument("sql_file", help="file holding the evolved SQL")
    ev.add_argument("--api", default="http://127.0.0.1:5115",
                    help="cluster API base url")
    ev.set_defaults(fn=_cmd_evolve)

    kp = sub.add_parser("check", help="static analysis of a SQL pipeline "
                                      "(plan + dataflow validation, no run)")
    kp.add_argument("sql_file")
    kp.add_argument("--parallelism", type=int, default=1)
    kp.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too")
    kp.add_argument("--json", action="store_true",
                    help="machine-readable diagnostics (rule, severity, "
                         "site, message, hint); exit codes unchanged")
    kp.add_argument("--sarif", action="store_true",
                    help="SARIF 2.1.0 diagnostics for CI inline "
                         "annotations; exit codes unchanged")
    kp.set_defaults(fn=_cmd_check)

    lp = sub.add_parser("lint", help="repo lint + replay-soundness audit: "
                                     "AST invariant checks over this "
                                     "codebase (tools/lint.sh entry)")
    lp.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the arroyo_tpu_torch package)")
    lp.add_argument("--json", action="store_true",
                    help="machine-readable diagnostics (rule, severity, "
                         "site, message, hint); exit codes unchanged")
    lp.add_argument("--sarif", action="store_true",
                    help="SARIF 2.1.0 diagnostics for CI inline "
                         "annotations; exit codes unchanged")
    lp.set_defaults(fn=_cmd_lint)

    fp = sub.add_parser("fsck", help="offline checkpoint-chain verifier: "
                                     "checksums, completeness, spill-run "
                                     "liveness, orphans (FS-series rules)")
    fp.add_argument("job_id", help="job whose checkpoint chain to verify")
    fp.add_argument("--storage-url", default=None,
                    help="checkpoint store prefix (default: "
                         "checkpoint.storage-url from config)")
    fp.add_argument("--json", action="store_true",
                    help="machine-readable diagnostics (rule, severity, "
                         "site, message, hint); exit codes unchanged")
    fp.add_argument("--sarif", action="store_true",
                    help="SARIF 2.1.0 diagnostics for CI inline "
                         "annotations; exit codes unchanged")
    fp.set_defaults(fn=_cmd_fsck)

    cs = sub.add_parser("compile-service",
                        help="standalone native-UDF compile service")
    cs.add_argument("--port", type=int, default=5117)
    cs.add_argument("--host", default="0.0.0.0")
    cs.add_argument("--artifacts-url", default=None,
                    help="storage prefix for built dylibs (local, s3:// or gs://)")
    cs.set_defaults(fn=_cmd_compile_service)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
