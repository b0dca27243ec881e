"""Pipeline/job store.

The port's copy of arroyo_tpu/controller/db.py.

Equivalent of the reference's Postgres/SQLite DB shared by arroyo-api and
arroyo-controller (cornucopia queries; controller polls it for desired-state
changes, lib.rs:543-567). SQLite via the stdlib; one writer lock because the
API server and controller share a process in the embedded deployment.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid
from typing import Any, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS pipelines (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL,
    query TEXT NOT NULL,
    parallelism INTEGER NOT NULL DEFAULT 1,
    version INTEGER NOT NULL DEFAULT 1,  -- bumped by each live evolution
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS jobs (
    id TEXT PRIMARY KEY,
    pipeline_id TEXT NOT NULL REFERENCES pipelines(id),
    state TEXT NOT NULL,
    desired_stop TEXT,            -- NULL | 'checkpoint' | 'immediate'
    desired_parallelism INTEGER,  -- non-NULL requests a live rescale
    desired_query TEXT,           -- non-NULL requests a live evolution
    restarts INTEGER NOT NULL DEFAULT 0,
    n_workers INTEGER NOT NULL DEFAULT 1,  -- size of the running worker set
    checkpoint_epoch INTEGER NOT NULL DEFAULT 0,
    restore_epoch INTEGER,
    failure_message TEXT,
    run_id INTEGER NOT NULL DEFAULT 0,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS nodes (
    id TEXT PRIMARY KEY,
    addr TEXT NOT NULL,
    slots INTEGER NOT NULL,
    last_heartbeat REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS udfs (
    name TEXT PRIMARY KEY,
    language TEXT NOT NULL,       -- 'cpp' | 'python'
    source TEXT NOT NULL,
    arg_dtypes TEXT NOT NULL,     -- JSON list (cpp only)
    return_dtype TEXT NOT NULL,
    artifact_url TEXT,            -- built dylib (cpp only)
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS connection_profiles (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL UNIQUE,
    connector TEXT NOT NULL,
    config TEXT NOT NULL,         -- JSON options shared by tables
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS connection_tables (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL UNIQUE,
    connector TEXT NOT NULL,
    profile_id TEXT REFERENCES connection_profiles(id),
    table_type TEXT NOT NULL,     -- 'source' | 'sink'
    config TEXT NOT NULL,         -- JSON connector options
    schema_fields TEXT NOT NULL,  -- JSON [{name, type, nullable}]
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS checkpoints (
    job_id TEXT NOT NULL,
    epoch INTEGER NOT NULL,
    state TEXT NOT NULL,          -- 'inprogress' | 'complete' | 'compacted' | 'failed'
    time REAL NOT NULL,
    phases TEXT,                  -- JSON {align,snapshot,ack,commit: seconds}
    PRIMARY KEY (job_id, epoch)
);
CREATE TABLE IF NOT EXISTS job_traces (
    job_id TEXT NOT NULL,
    epoch INTEGER NOT NULL,
    events TEXT NOT NULL,         -- JSON epoch-lifecycle span events
    updated_at REAL NOT NULL,
    PRIMARY KEY (job_id, epoch)
);
CREATE TABLE IF NOT EXISTS job_outputs (
    job_id TEXT NOT NULL,
    seq INTEGER NOT NULL,
    line TEXT NOT NULL,
    PRIMARY KEY (job_id, seq)
);
CREATE TABLE IF NOT EXISTS job_metrics (
    job_id TEXT PRIMARY KEY,
    data TEXT NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS job_profiles (
    job_id TEXT PRIMARY KEY,
    data TEXT NOT NULL,           -- JSON compact per-operator cost profile
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS job_events (
    job_id TEXT NOT NULL,
    seq INTEGER NOT NULL,         -- controller-side event-log seq (cursor)
    ts_us INTEGER NOT NULL,
    level TEXT NOT NULL,          -- DEBUG | INFO | WARN | ERROR
    code TEXT NOT NULL,           -- stable EventCode (obs.events)
    node TEXT,                    -- scope: operator node id
    subtask INTEGER,
    worker INTEGER,
    epoch INTEGER,
    message TEXT NOT NULL,
    data TEXT,                    -- JSON extra payload
    PRIMARY KEY (job_id, seq)
);
CREATE TABLE IF NOT EXISTS job_health (
    job_id TEXT PRIMARY KEY,
    state TEXT NOT NULL,          -- ok | degraded | critical
    data TEXT NOT NULL,           -- JSON per-rule detail (obs.health)
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS fleet_state (
    id INTEGER PRIMARY KEY CHECK (id = 1),  -- singleton snapshot row
    data TEXT NOT NULL,           -- JSON (controller/fleet.py stats())
    updated_at REAL NOT NULL
);
"""

_OUTPUT_CAP = 10_000  # preview rows retained per job


class Database:
    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        with self._lock:
            self._conn.executescript(_SCHEMA)
            # additive migration for databases created by older builds
            # (CREATE TABLE IF NOT EXISTS leaves existing tables untouched)
            for migration in (
                "ALTER TABLE jobs ADD COLUMN desired_parallelism INTEGER",
                "ALTER TABLE jobs ADD COLUMN n_workers INTEGER NOT NULL DEFAULT 1",
                "ALTER TABLE jobs ADD COLUMN health TEXT",
                "ALTER TABLE jobs ADD COLUMN tenant TEXT NOT NULL DEFAULT 'default'",
                "ALTER TABLE jobs ADD COLUMN desired_query TEXT",
                "ALTER TABLE pipelines ADD COLUMN version INTEGER NOT NULL DEFAULT 1",
                "ALTER TABLE checkpoints ADD COLUMN phases TEXT",
            ):
                try:
                    self._conn.execute(migration)
                except sqlite3.OperationalError as e:
                    if "duplicate column" not in str(e).lower():
                        raise  # locked/readonly/corrupt db: fail loudly, not later
            self._conn.commit()

    # ------------------------------------------------------------ pipelines

    def create_pipeline(self, name: str, query: str, parallelism: int = 1) -> str:
        pid = f"pl_{uuid.uuid4().hex[:12]}"
        with self._lock:
            self._conn.execute(
                "INSERT INTO pipelines (id, name, query, parallelism, created_at) "
                "VALUES (?,?,?,?,?)",
                (pid, name, query, parallelism, time.time()),
            )
            self._conn.commit()
        return pid

    def get_pipeline(self, pid: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute("SELECT * FROM pipelines WHERE id=?", (pid,)).fetchone()
        return dict(row) if row else None

    def list_pipelines(self) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM pipelines ORDER BY created_at DESC"
            ).fetchall()
        return [dict(r) for r in rows]

    def set_pipeline_parallelism(self, pid: str, parallelism: int) -> None:
        """Persist a completed rescale so restarts keep the new scale."""
        with self._lock:
            self._conn.execute(
                "UPDATE pipelines SET parallelism=? WHERE id=?", (parallelism, pid))
            self._conn.commit()

    def evolve_pipeline_query(self, pid: str, query: str) -> int:
        """Persist a completed live evolution: the pipeline's query becomes
        the evolved SQL and its version lineage advances. Returns the new
        version. Restarts re-plan from this row, so a job restarted after
        the evolution committed runs the evolved plan."""
        with self._lock:
            self._conn.execute(
                "UPDATE pipelines SET query=?, version=version+1 WHERE id=?",
                (query, pid))
            self._conn.commit()
            row = self._conn.execute(
                "SELECT version FROM pipelines WHERE id=?", (pid,)).fetchone()
        return int(row["version"]) if row else 0

    def clear_desired_query(self, jid: str, expected: str) -> None:
        """Clear the evolve request iff it still holds the SQL we just
        applied; a newer concurrent request survives to trigger again."""
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET desired_query=NULL, updated_at=? "
                "WHERE id=? AND desired_query=?",
                (time.time(), jid, expected))
            self._conn.commit()

    def delete_pipeline(self, pid: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM jobs WHERE pipeline_id=?", (pid,))
            self._conn.execute("DELETE FROM pipelines WHERE id=?", (pid,))
            self._conn.commit()

    # ----------------------------------------------------------------- jobs

    def create_job(self, pipeline_id: str, tenant: str = "default") -> str:
        """``tenant`` keys the fleet's per-tenant admission queues and
        quotas (controller/fleet.py)."""
        jid = f"job_{uuid.uuid4().hex[:12]}"
        with self._lock:
            self._conn.execute(
                "INSERT INTO jobs (id, pipeline_id, state, tenant, "
                "updated_at) VALUES (?,?,?,?,?)",
                (jid, pipeline_id, "Created", tenant or "default",
                 time.time()),
            )
            self._conn.commit()
        return jid

    def get_job(self, jid: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute("SELECT * FROM jobs WHERE id=?", (jid,)).fetchone()
        return dict(row) if row else None

    def list_jobs(self, pipeline_id: Optional[str] = None) -> list[dict]:
        with self._lock:
            if pipeline_id:
                rows = self._conn.execute(
                    "SELECT * FROM jobs WHERE pipeline_id=? ORDER BY updated_at DESC",
                    (pipeline_id,),
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT * FROM jobs ORDER BY updated_at DESC"
                ).fetchall()
        return [dict(r) for r in rows]

    def set_desired_parallelism_if_unset(self, jid: str, target: int) -> bool:
        """Compare-and-set for the autoscaler's actuation: the write lands
        only while no rescale request is pending, so a manual PATCH racing
        in between the controller's job-row read and this write is never
        clobbered (manual requests always win). Returns True iff set."""
        with self._lock:
            cur = self._conn.execute(
                "UPDATE jobs SET desired_parallelism=?, updated_at=? "
                "WHERE id=? AND desired_parallelism IS NULL",
                (int(target), time.time(), jid))
            self._conn.commit()
            return cur.rowcount > 0

    def clear_desired_parallelism(self, jid: str, expected: int) -> None:
        """Clear the rescale request iff it still holds the value we just
        applied; a newer concurrent request survives to trigger again."""
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET desired_parallelism=NULL, updated_at=? "
                "WHERE id=? AND desired_parallelism=?",
                (time.time(), jid, expected))
            self._conn.commit()

    def update_job(self, jid: str, **fields: Any) -> None:
        if not fields:
            return
        cols = ", ".join(f"{k}=?" for k in fields)
        with self._lock:
            self._conn.execute(
                f"UPDATE jobs SET {cols}, updated_at=? WHERE id=?",
                (*fields.values(), time.time(), jid),
            )
            self._conn.commit()

    # ----------------------------------------------------------------- nodes

    def register_node(self, node_id: str, addr: str, slots: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO nodes (id, addr, slots, last_heartbeat) VALUES (?,?,?,?) "
                "ON CONFLICT(id) DO UPDATE SET addr=excluded.addr, "
                "slots=excluded.slots, last_heartbeat=excluded.last_heartbeat",
                (node_id, addr, slots, time.time()),
            )
            self._conn.commit()

    def node_heartbeat(self, node_id: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE nodes SET last_heartbeat=? WHERE id=?", (time.time(), node_id)
            )
            self._conn.commit()
            return cur.rowcount > 0

    def list_nodes(self, alive_within_s: Optional[float] = None) -> list[dict]:
        with self._lock:
            rows = self._conn.execute("SELECT * FROM nodes ORDER BY id").fetchall()
        out = [dict(r) for r in rows]
        if alive_within_s is not None:
            cutoff = time.time() - alive_within_s
            out = [n for n in out if n["last_heartbeat"] >= cutoff]
        return out

    # ------------------------------------------------------------------ udfs

    def create_udf(self, name: str, language: str, source: str,
                   arg_dtypes: list[str], return_dtype: str,
                   artifact_url: Optional[str]) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO udfs (name, language, source, arg_dtypes, "
                "return_dtype, artifact_url, created_at) VALUES (?,?,?,?,?,?,?) "
                "ON CONFLICT(name) DO UPDATE SET language=excluded.language, "
                "source=excluded.source, arg_dtypes=excluded.arg_dtypes, "
                "return_dtype=excluded.return_dtype, "
                "artifact_url=excluded.artifact_url",
                (name, language, source, json.dumps(arg_dtypes), return_dtype,
                 artifact_url, time.time()),
            )
            self._conn.commit()

    def list_udfs(self) -> list[dict]:
        with self._lock:
            rows = self._conn.execute("SELECT * FROM udfs ORDER BY name").fetchall()
        out = []
        for r in rows:
            d = dict(r)
            d["arg_dtypes"] = json.loads(d["arg_dtypes"])
            out.append(d)
        return out

    def delete_udf(self, name: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM udfs WHERE name=?", (name,))
            self._conn.commit()

    # ------------------------------------------------- connection tables

    def create_connection_profile(self, name: str, connector: str,
                                  config: dict) -> str:
        cid = f"cp_{uuid.uuid4().hex[:12]}"
        with self._lock:
            self._conn.execute(
                "INSERT INTO connection_profiles (id, name, connector, config, "
                "created_at) VALUES (?,?,?,?,?)",
                (cid, name, connector, json.dumps(config), time.time()))
            self._conn.commit()
        return cid

    def list_connection_profiles(self) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM connection_profiles ORDER BY name").fetchall()
        out = []
        for r in rows:
            d = dict(r)
            d["config"] = json.loads(d["config"])
            out.append(d)
        return out

    def delete_connection_profile(self, cid: str) -> bool:
        with self._lock:
            used = self._conn.execute(
                "SELECT COUNT(*) FROM connection_tables WHERE profile_id=?",
                (cid,)).fetchone()[0]
            if used:
                return False
            self._conn.execute(
                "DELETE FROM connection_profiles WHERE id=?", (cid,))
            self._conn.commit()
        return True

    def create_connection_table(self, name: str, connector: str,
                                table_type: str, config: dict,
                                schema_fields: list[dict],
                                profile_id: Optional[str] = None) -> str:
        tid = f"ct_{uuid.uuid4().hex[:12]}"
        with self._lock:
            self._conn.execute(
                "INSERT INTO connection_tables (id, name, connector, profile_id, "
                "table_type, config, schema_fields, created_at) "
                "VALUES (?,?,?,?,?,?,?,?)",
                (tid, name, connector, profile_id, table_type,
                 json.dumps(config), json.dumps(schema_fields), time.time()))
            self._conn.commit()
        return tid

    def list_connection_tables(self) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM connection_tables ORDER BY name").fetchall()
        out = []
        for r in rows:
            d = dict(r)
            d["config"] = json.loads(d["config"])
            d["schema_fields"] = json.loads(d["schema_fields"])
            out.append(d)
        return out

    def delete_connection_table(self, tid: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM connection_tables WHERE id=?", (tid,))
            self._conn.commit()

    # ---------------------------------------------------------- checkpoints

    def record_checkpoint(self, job_id: str, epoch: int, state: str,
                          phases: Optional[dict] = None) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO checkpoints (job_id, epoch, state, time, phases) "
                "VALUES (?,?,?,?,?) "
                "ON CONFLICT(job_id, epoch) DO UPDATE SET state=excluded.state, "
                "time=excluded.time, "
                # a later state-only update ('compacted') keeps the phases
                "phases=COALESCE(excluded.phases, checkpoints.phases)",
                (job_id, epoch, state, time.time(),
                 json.dumps(phases) if phases else None),
            )
            self._conn.commit()

    def list_checkpoints(self, job_id: str) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM checkpoints WHERE job_id=? ORDER BY epoch", (job_id,)
            ).fetchall()
        return [dict(r) for r in rows]

    _TRACE_CAP = 32  # newest epochs retained per job (mirrors the recorder)

    def record_trace(self, job_id: str, epoch: int, events: list[dict]) -> None:
        """Persist one epoch's lifecycle span events (obs.trace), bounded to
        the newest _TRACE_CAP epochs per job."""
        if not events:
            return
        with self._lock:
            self._conn.execute(
                "INSERT INTO job_traces (job_id, epoch, events, updated_at) "
                "VALUES (?,?,?,?) ON CONFLICT(job_id, epoch) DO UPDATE SET "
                "events=excluded.events, updated_at=excluded.updated_at",
                (job_id, epoch, json.dumps(events), time.time()),
            )
            self._conn.execute(
                "DELETE FROM job_traces WHERE job_id=? AND epoch NOT IN ("
                "SELECT epoch FROM job_traces WHERE job_id=? "
                "ORDER BY epoch DESC LIMIT ?)",
                (job_id, job_id, self._TRACE_CAP),
            )
            self._conn.commit()

    def list_traces(self, job_id: str,
                    epoch: Optional[int] = None) -> list[dict]:
        """[{epoch, events: [...]}] oldest epoch first."""
        with self._lock:
            if epoch is None:
                rows = self._conn.execute(
                    "SELECT epoch, events FROM job_traces WHERE job_id=? "
                    "ORDER BY epoch", (job_id,)).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT epoch, events FROM job_traces WHERE job_id=? "
                    "AND epoch=?", (job_id, epoch)).fetchall()
        return [{"epoch": int(r["epoch"]), "events": json.loads(r["events"])}
                for r in rows]

    # -------------------------------------------------- preview output

    def record_output(self, job_id: str, lines: list[str]) -> None:
        """Append preview sink rows (reference: SendSinkData gRPC rows
        buffered controller-side for the UI), bounded per job."""
        if not lines:
            return
        with self._lock:
            row = self._conn.execute(
                "SELECT COALESCE(MAX(seq), -1) AS m FROM job_outputs WHERE job_id=?",
                (job_id,),
            ).fetchone()
            seq = int(row["m"]) + 1
            self._conn.executemany(
                "INSERT INTO job_outputs (job_id, seq, line) VALUES (?,?,?)",
                [(job_id, seq + i, l) for i, l in enumerate(lines)],
            )
            self._conn.execute(
                "DELETE FROM job_outputs WHERE job_id=? AND seq <= ?",
                (job_id, seq + len(lines) - 1 - _OUTPUT_CAP),
            )
            self._conn.commit()

    def list_outputs(self, job_id: str, after_seq: int = -1, limit: int = 1000) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT seq, line FROM job_outputs WHERE job_id=? AND seq > ? "
                "ORDER BY seq LIMIT ?",
                (job_id, after_seq, limit),
            ).fetchall()
        return [dict(r) for r in rows]

    def record_metrics(self, job_id: str, data: dict) -> None:
        """Latest per-operator metrics snapshot (workers ship these over
        the control protocol; reference JobMetrics gRPC + 1s scrape)."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO job_metrics (job_id, data, updated_at) VALUES (?,?,?) "
                "ON CONFLICT(job_id) DO UPDATE SET data=excluded.data, "
                "updated_at=excluded.updated_at",
                (job_id, json.dumps(data), time.time()),
            )
            self._conn.commit()

    def get_metrics(self, job_id: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM job_metrics WHERE job_id=?", (job_id,)
            ).fetchone()
        return json.loads(row["data"]) if row else None

    _EVENTS_CAP = 1000  # newest structured events retained per job

    def record_events(self, job_id: str, events: list[dict]) -> None:
        """Append structured job events (obs.events dicts carrying the
        controller-side ``seq``), bounded to the newest _EVENTS_CAP per
        job. Idempotent per (job, seq): a re-flushed event is skipped
        rather than duplicated."""
        if not events:
            return
        with self._lock:
            self._conn.executemany(
                "INSERT INTO job_events (job_id, seq, ts_us, level, code, "
                "node, subtask, worker, epoch, message, data) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?) "
                "ON CONFLICT(job_id, seq) DO NOTHING",
                [(job_id, int(e["seq"]), int(e["ts_us"]), e["level"],
                  e["code"], e.get("node"), e.get("subtask"),
                  e.get("worker"), e.get("epoch"), e.get("message", ""),
                  json.dumps(e.get("data") or {}))
                 for e in events],
            )
            self._conn.execute(
                "DELETE FROM job_events WHERE job_id=? AND seq <= ("
                "SELECT MAX(seq) FROM job_events WHERE job_id=?) - ?",
                (job_id, job_id, self._EVENTS_CAP),
            )
            self._conn.commit()

    def list_events(self, job_id: str, level: Optional[str] = None,
                    since: Optional[float] = None, after_seq: int = 0,
                    limit: int = 1000) -> list[dict]:
        """Structured events oldest first; ``level`` is a minimum (WARN
        returns WARN+ERROR), ``since`` a unix-seconds floor, ``after_seq``
        the incremental-tail cursor (`logs --follow` / API ?after=)."""
        from ..obs.events import level_rank

        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM job_events WHERE job_id=? AND seq > ? "
                "ORDER BY seq LIMIT ?",
                (job_id, int(after_seq), int(limit))).fetchall()
        out = []
        floor = level_rank(level) if level is not None else None
        for r in rows:
            e = dict(r)
            e.pop("job_id", None)
            e["data"] = json.loads(e["data"]) if e["data"] else {}
            if floor is not None and level_rank(e["level"]) < floor:
                continue
            if since is not None and e["ts_us"] < since * 1e6:
                continue
            out.append(e)
        return out

    def last_event_seq(self, job_id: str) -> int:
        """Max persisted event seq for a job — a restarted controller
        seeds the in-memory event log past it (obs.events
        ``ensure_seq_floor``) so post-restart events don't collide with
        already-persisted (job, seq) rows."""
        with self._lock:
            row = self._conn.execute(
                "SELECT MAX(seq) AS s FROM job_events WHERE job_id=?",
                (job_id,)).fetchone()
        return int(row["s"] or 0)

    def record_health(self, job_id: str, state: str, data: dict) -> None:
        """Latest per-rule health detail (obs.health.HealthMonitor
        evaluation) behind GET /api/v1/jobs/<id>/health."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO job_health (job_id, state, data, updated_at) "
                "VALUES (?,?,?,?) ON CONFLICT(job_id) DO UPDATE SET "
                "state=excluded.state, data=excluded.data, "
                "updated_at=excluded.updated_at",
                (job_id, state, json.dumps(data), time.time()),
            )
            self._conn.commit()

    def get_health(self, job_id: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT state, data, updated_at FROM job_health WHERE job_id=?",
                (job_id,)).fetchone()
        if row is None:
            return None
        out = json.loads(row["data"])
        out["state"] = row["state"]
        out["updated_at"] = row["updated_at"]
        return out

    def record_fleet_state(self, data: dict) -> None:
        """Latest fleet snapshot (controller/fleet.py stats(): pool size,
        used/free slots, per-tenant usage, the admission queue with
        positions) — what GET /api/v1/fleet and queued jobs' API queue
        positions serve, cross-process."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO fleet_state (id, data, updated_at) "
                "VALUES (1,?,?) ON CONFLICT(id) DO UPDATE SET "
                "data=excluded.data, updated_at=excluded.updated_at",
                (json.dumps(data), time.time()),
            )
            self._conn.commit()

    def get_fleet_state(self) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT data, updated_at FROM fleet_state WHERE id=1"
            ).fetchone()
        if row is None:
            return None
        out = json.loads(row["data"])
        out["updated_at"] = row["updated_at"]
        return out

    def fleet_queue_position(self, job_id: str) -> Optional[int]:
        """1-based admission-queue position of a Queued job, from the
        persisted fleet snapshot — the one lookup both the jobs API and
        `top --db` attach to queued job rows."""
        fleet = self.get_fleet_state() or {}
        for e in fleet.get("queue") or []:
            if e.get("job_id") == job_id:
                return e.get("position")
        return None

    def record_profile(self, job_id: str, data: dict) -> None:
        """Latest compact per-operator cost profile (obs.profile.job_profile
        over the merged worker snapshots): busy%, self-time, state sizes,
        hot keys — what `explain`/`/profile` serve."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO job_profiles (job_id, data, updated_at) VALUES (?,?,?) "
                "ON CONFLICT(job_id) DO UPDATE SET data=excluded.data, "
                "updated_at=excluded.updated_at",
                (job_id, json.dumps(data), time.time()),
            )
            self._conn.commit()

    def get_profile(self, job_id: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM job_profiles WHERE job_id=?", (job_id,)
            ).fetchone()
        return json.loads(row["data"]) if row else None

    def close(self) -> None:
        with self._lock:
            self._conn.close()
