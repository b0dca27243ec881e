"""Tiered state: spill cold per-key state to storage (the port's copy of
arroyo_tpu/state/spill.py; host code in both packages).

Per-key operator state (the updating aggregate's accumulators, the updating
join's side stores) may not fit one subtask's memory. The operator keeps its
HOT working set in memory; when the per-subtask budget
(``state.spill.budget-bytes``, against the operator's own estimate of its
resident bytes) is breached, the coldest hash-range partitions
(a deterministic logical-clock LRU, never wall time) are written as
immutable *runs* through ``state/storage.py`` and its retry layer.

Every run carries a bloom filter and min/max zone maps over the key hash and
the row event time, so a probe (``KeyedSpillAnnex.lookup_many``,
``RowSpillAnnex.probe``) reads only the files that can hold the key.

Ownership protocol:

  * a key's newest copy wins: the hot dict shadows every run, a newer run
    shadows older runs (runs are scanned newest-first).
  * promote-and-disown: a key promoted back into the hot tier is
    tombstoned in the annex. Tombstones fold into the next spilled run as
    dead rows and are dropped when a full-partition compaction proves no
    older copy remains.
  * spill is all-or-nothing: the run files land durably BEFORE the keys
    leave the hot dict. A storage failure mid-spill re-pins the partition
    hot, emits ``SPILL_FALLBACK`` and backs off; it never corrupts state.
  * checkpoints reference runs by manifest (``checkpoint_manifest`` into a
    ``<table>__spill`` global table), never re-upload them; restore rebuilds
    the tiered layout (runs, tombstones, access clocks).

Run files live under ``{storage_url}/{job}/spill/operator-{node}/``, outside
the per-epoch checkpoint dirs: one run is referenced by many epochs.
``cleanup_spill_runs`` deletes a run only when no surviving checkpoint
references it and its epoch tag shows it is not a fresh post-checkpoint
file.

Run files and manifests are the JAX package's, byte for byte: a run either
package wrote is read by the other. A run's payloads are pickles of built-in
and numpy values only, and are read back through the checkpoint tables'
restricted unpickler, which refuses any other class.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Callable, Iterable, Optional

import numpy as np

from ..hashing import splitmix64
from ..metrics import Histogram
from . import storage
from .tables import loads_values, read_columnar, write_columnar

_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_BLOOM_SALT = np.uint64(0xA5A5A5A55A5A5A5A)

# files touched per probe: the zone-map/bloom effectiveness signal
# (0 = pruned everything; a growing tail means compaction is falling behind)
PROBE_FILES_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

_RUN_NAME_RE = re.compile(r"^run-.+-s(\d+)-e(\d+)-(\d+)")


def _config():
    from ..config import config

    return config()


def spill_enabled() -> bool:
    return bool(_config().get("state.spill.enabled", False))


# after a spill, resident state shrinks to budget * SPILL_HEADROOM (a
# low-water mark, so the next batches do not spill again at once)
SPILL_HEADROOM = 0.75
# hash-range partitions per subtask (rounded up to a power of two)
PARTITION_COUNT = 16
# run files of roughly this size; also compaction's output size
TARGET_FILE_BYTES = 4 * 1024 * 1024
# generations per partition before an online compaction merges them
MAX_RUNS = 4


def spill_budget_bytes() -> int:
    return int(_config().get("state.spill.budget-bytes", 64 * 1024 * 1024))


def _u64(h: int) -> int:
    return h & 0xFFFFFFFFFFFFFFFF


def _i64(u: int) -> int:
    u = int(u)
    return u - (1 << 64) if u >= (1 << 63) else u


class SpillStats:
    """Per-operator spill counters (single writer: the task thread).
    Shared by the operator's annexes and read by ``TaskProfiler.refresh``
    into the ``arroyo_spill_*`` metric families."""

    __slots__ = ("bytes_total", "runs_written", "probes", "promotions", "probe_files",
                 "compactions", "failures")

    def __init__(self):
        self.bytes_total = 0
        self.runs_written = 0
        self.probes = 0
        self.promotions = 0  # probes that promoted a key or a row back (the port's counter)
        self.probe_files = Histogram(PROBE_FILES_BUCKETS)
        self.compactions = 0
        self.failures = 0


def merge_spill_stats(parts: list[Optional[dict]]) -> Optional[dict]:
    """Fold several ``spill_stats()`` dicts (e.g. a chain's members) into
    one: counters sum, the probe-files histograms merge bucket-wise."""
    parts = [p for p in parts if p]
    if not parts:
        return None
    hist = Histogram(PROBE_FILES_BUCKETS)
    out = {"bytes_total": 0, "hot": 0, "cold": 0, "probe_files": hist}
    for p in parts:
        out["bytes_total"] += int(p.get("bytes_total", 0))
        out["hot"] += int(p.get("hot", 0))
        out["cold"] += int(p.get("cold", 0))
        h = p.get("probe_files")
        if isinstance(h, Histogram) and tuple(h.buckets) == PROBE_FILES_BUCKETS:
            for i, c in enumerate(h.counts):
                hist.counts[i] += c
            hist.count += h.count
            hist.sum += h.sum
    return out


# ---------------------------------------------------------------- bloom


class BloomFilter:
    """Deterministic bloom filter over u64 key hashes (double hashing via
    two splitmix64 lanes; ~1% false positives at 10 bits/key, k=7)."""

    __slots__ = ("m", "k", "words")

    def __init__(self, m: int, k: int, words: np.ndarray):
        self.m = m
        self.k = k
        self.words = words

    @staticmethod
    def build(keys_u64: np.ndarray, bits_per_key: int = 10,
              k: int = 7) -> "BloomFilter":
        n = max(1, len(keys_u64))
        m = ((bits_per_key * n + 63) // 64) * 64
        words = np.zeros(m // 64, dtype=np.uint64)
        if len(keys_u64):
            keys_u64 = np.asarray(keys_u64, dtype=np.uint64)
            h1 = splitmix64(keys_u64)
            h2 = splitmix64(keys_u64 ^ _BLOOM_SALT)
            for i in range(k):
                idx = (h1 + np.uint64(i) * h2) % np.uint64(m)
                np.bitwise_or.at(
                    words, (idx >> np.uint64(6)).astype(np.int64),
                    np.uint64(1) << (idx & np.uint64(63)))
        return BloomFilter(m, k, words)

    def contains(self, keys_u64: np.ndarray) -> np.ndarray:
        """Boolean mask per key: True = possibly present."""
        keys_u64 = np.asarray(keys_u64, dtype=np.uint64)
        if not len(keys_u64):
            return np.zeros(0, dtype=bool)
        h1 = splitmix64(keys_u64)
        h2 = splitmix64(keys_u64 ^ _BLOOM_SALT)
        ok = np.ones(len(keys_u64), dtype=bool)
        for i in range(self.k):
            idx = (h1 + np.uint64(i) * h2) % np.uint64(self.m)
            bits = (self.words[(idx >> np.uint64(6)).astype(np.int64)]
                    >> (idx & np.uint64(63))) & np.uint64(1)
            ok &= bits != 0
        return ok

    def state(self) -> dict:
        return {"m": self.m, "k": self.k, "words": self.words.tobytes()}

    @staticmethod
    def from_state(d: dict) -> "BloomFilter":
        return BloomFilter(int(d["m"]), int(d["k"]),
                           np.frombuffer(d["words"], dtype=np.uint64).copy())


# ------------------------------------------------------------ run plumbing


def _zone_overlaps(meta: dict, lo: int, hi: int) -> bool:
    return not (meta["min_key"] > hi or meta["max_key"] < lo)


class _AnnexBase:
    """Shared plumbing of both annex flavors: run naming, fault-guarded
    file IO, the shared stats object, and the structured-event emitter."""

    def __init__(self, task_info, storage_url: str, table: str,
                 stats: Optional[SpillStats] = None):
        self.task_info = task_info
        self.table = table
        self.dir = os.path.join(storage_url, task_info.job_id, "spill",
                                f"operator-{task_info.node_id}")
        self.key_lo, self.key_hi = task_info.key_range
        self.target_file_bytes = TARGET_FILE_BYTES
        self.max_runs = max(2, MAX_RUNS)
        self.stats = stats if stats is not None else SpillStats()
        self.epoch = 0  # last barrier epoch; tags run names for safe GC
        self.next_seq = 1
        # call-count backoffs after a failed write (deterministic, no
        # clocks): spill and compaction back off independently — memory
        # relief must not stall because a merge failed, and vice versa
        self._skip_spills = 0
        self._skip_compacts = 0
        self._made_dirs = False
        self._announced = False

    # -- events ------------------------------------------------------------

    def _emit(self, level: str, code: str, message: str, data: dict) -> None:
        from ..obs.events import recorder

        ti = self.task_info
        recorder.record(ti.job_id, level, code, message, node=ti.node_id,
                        subtask=ti.subtask_index, data=data)

    def _announce_spill(self, data: dict) -> None:
        if not self._announced:
            self._announced = True
            self._emit("INFO", "SPILL_STARTED",
                       f"state spilling engaged for table {self.table!r}",
                       data)

    def _degrade(self, what: str, err: Exception) -> None:
        self.stats.failures += 1
        self._emit("WARN", "SPILL_FALLBACK",
                   f"{what} failed for table {self.table!r}; state stays "
                   "resident and the failed path backs off",
                   {"table": self.table, "reason": str(err)[:200]})

    # -- file IO -----------------------------------------------------------

    def _run_name(self, seq: int) -> str:
        from .tables import _checkpoint_format

        ext = "parquet" if _checkpoint_format() == "parquet" else "npz"
        # the table name disambiguates annexes sharing one operator dir
        # (a join's left/right sides each keep their own seq counter)
        return (f"run-{self.table}-s{self.task_info.subtask_index:03d}"
                f"-e{self.epoch:07d}-{seq:06d}.{ext}")

    def _write_run(self, site: str, name: str, cols: dict) -> None:
        from ..faults import fault_point

        if not self._made_dirs:
            storage.makedirs(self.dir)
            self._made_dirs = True
        path = os.path.join(self.dir, name)
        fault_point(site, key=path, epoch=self.epoch,
                    subtask=self.task_info.subtask_index)
        # runs outlive the epoch whose manifest references them, so they
        # carry a self-describing integrity footer instead of a manifest
        # envelope (read_columnar strips + verifies it)
        write_columnar(path, cols, footer=True)

    def _read_run(self, meta: dict) -> dict:
        """Probe-path read: one in-place retry (an injected ``fail_once``
        or a transient blip the storage retry budget exhausted recovers
        here); a second failure propagates — the data exists only in this
        file, so the honest degradation is the task failing and the
        worker set restoring from the checkpoint, state intact."""
        from ..faults import fault_point

        path = os.path.join(self.dir, meta["file"])
        try:
            fault_point("spill_probe", key=path, epoch=self.epoch,
                        subtask=self.task_info.subtask_index)
            return read_columnar(path)
        except Exception:  # noqa: BLE001 - retried once, then propagates
            fault_point("spill_probe", key=path, epoch=self.epoch,
                        subtask=self.task_info.subtask_index)
            return read_columnar(path)

    def _bloom(self, meta: dict) -> BloomFilter:
        b = meta.get("__bloom_obj")
        if b is None:
            b = BloomFilter.from_state(meta["bloom"])
            meta["__bloom_obj"] = b
        return b


# ---------------------------------------------------------- keyed annex


class KeyedSpillAnnex(_AnnexBase):
    """Cold tier for keyed record state (one mutable record per key hash),
    the shape of ``UpdatingAggregate``'s accumulator map.

    The annex never holds the hot tier: the operator's own dict does. The
    annex owns the spilled runs, the per-partition tombstone sets, and the
    deterministic access clock that picks eviction victims. Values cross
    the boundary as ``pack()``-ed picklable payloads.
    """

    def __init__(self, task_info, storage_url: str, table: str,
                 stats: Optional[SpillStats] = None):
        super().__init__(task_info, storage_url, table, stats)
        pc = PARTITION_COUNT
        # PARTITION_COUNT is PER SUBTASK: subtasks own
        # contiguous top-bit slices of the hash space, so the global split
        # scales with parallelism to keep ~pc partitions inside each
        # subtask's range (otherwise high parallelism degenerates every
        # subtask to one victim and the clock LRU is vacuous). Powers of
        # two (>= 2: a 64-bit shift is undefined) so the partition is just
        # the hash's top bits; capped so run bookkeeping stays bounded.
        per_subtask = max(2, 1 << max(0, (pc - 1).bit_length()))
        par = max(1, 1 << max(0, (task_info.parallelism - 1).bit_length()))
        self.pc = min(1 << 16, per_subtask * par)
        self.shift = np.uint64(64 - self.pc.bit_length() + 1)
        self.runs: list[dict] = []  # oldest -> newest
        self.tombstones: dict[int, set[int]] = {}
        self.last_access: dict[int, int] = {}
        self.clock = 0

    # -- partitioning / clock ---------------------------------------------

    def partition_of(self, h: int) -> int:
        return int(np.uint64(_u64(h)) >> self.shift)

    def partitions_of(self, hashes: np.ndarray) -> np.ndarray:
        u = np.asarray(hashes).astype(np.int64).view(np.uint64)
        return (u >> self.shift).astype(np.int64)

    def touch(self, hashes: np.ndarray) -> None:
        """Advance the access clock for every partition the batch touched
        (one tick per call: replay-deterministic, no wall time)."""
        if not len(hashes):
            return
        self.clock += 1
        for p in np.unique(self.partitions_of(hashes)).tolist():
            self.last_access[p] = self.clock

    def has_runs(self) -> bool:
        return bool(self.runs)

    def local_partitions(self) -> int:
        """Partitions intersecting this subtask's key range (the
        denominator of the hot/cold gauge split)."""
        return (self.partition_of(self.key_hi)
                - self.partition_of(self.key_lo) + 1)

    def cold_partitions(self) -> int:
        return len({int(np.uint64(r["min_key"]) >> self.shift)
                    for r in self.runs})

    # -- probe -------------------------------------------------------------

    def lookup_many(self, hashes: Iterable[int]) -> dict[int, object]:
        """Resolve the newest spilled copy of each key and PROMOTE it: the
        returned keys are tombstoned (the caller's hot dict owns them now).
        Bloom + key zone maps prune the files touched; the histogram of
        files-per-probe is the pruning-effectiveness signal."""
        want = [h for h in hashes
                if h not in self.tombstones.get(self.partition_of(h), ())]
        self.stats.probes += 1
        if not want or not self.runs:
            self.stats.probe_files.observe(0)
            return {}
        found: dict[int, object] = {}
        files = 0
        pending = np.array(sorted(want), dtype=np.int64)
        for meta in reversed(self.runs):  # newest copy wins
            if not len(pending):
                break
            u = pending.view(np.uint64)
            lo, hi = int(u.min()), int(u.max())
            if not _zone_overlaps(meta, lo, hi):
                continue
            mask = self._bloom(meta).contains(u)
            if not mask.any():
                continue
            files += 1
            cols = self._read_run(meta)
            rk = np.asarray(cols["_key"], dtype=np.uint64).view(np.int64)
            hit = np.isin(pending[mask], rk)
            cand = pending[mask][hit]
            if len(cand):
                dead_col = np.asarray(cols["__dead"], dtype=bool)
                vals = cols["__val"]
                idx = {int(k): j for j, k in enumerate(rk.tolist())}
                for h in cand.tolist():
                    j = idx[h]
                    if not dead_col[j]:  # a dead row shadows older copies
                        found[h] = loads_values(vals[j])
                pending = pending[~np.isin(pending, cand)]
        self.stats.probe_files.observe(files)
        self.stats.promotions += bool(found)
        for h in found:
            self.tombstones.setdefault(self.partition_of(h), set()).add(h)
        return found

    def tombstone(self, h: int) -> None:
        """Disown a key explicitly (a hot key died while stale copies may
        remain in runs). Promote paths tombstone automatically."""
        if self.runs:
            self.tombstones.setdefault(self.partition_of(h), set()).add(h)

    # -- spill -------------------------------------------------------------

    def pick_victims(self, hot_counts: dict[int, int],
                     excess_entries: int) -> list[int]:
        """Coldest partitions first (logical-clock LRU, partition id as the
        deterministic tie-break) until ``excess_entries`` hot entries are
        covered."""
        order = sorted((p for p, c in hot_counts.items() if c),
                       key=lambda p: (self.last_access.get(p, 0), p))
        out, covered = [], 0
        for p in order:
            if covered >= excess_entries:
                break
            out.append(p)
            covered += hot_counts[p]
        return out

    def spill(self, partition: int, items: list[tuple[int, object]]) -> bool:
        """Write one partition's hot entries (plus its tombstones as dead
        rows) as new run file(s). All-or-nothing: runs register only after
        every chunk is durable; on failure nothing changed and the caller
        keeps the entries hot. Returns True when the caller may drop them."""
        if self._skip_spills > 0:
            self._skip_spills -= 1
            return False
        items = sorted(items, key=lambda kv: _u64(kv[0]))
        alive_keys = {h for h, _v in items}
        dead = sorted((self.tombstones.get(partition) or set()) - alive_keys,
                      key=_u64)
        if not items and not dead:
            return True
        rows: list[tuple[int, bytes, int, bool]] = []  # (h, payload, ts, dead)
        for h, v in items:
            payload = pickle.dumps(v, protocol=4)
            rows.append((h, payload, int(self._ts_of_packed(v)), False))
        rows.extend((h, b"", 0, True) for h in dead)
        rows.sort(key=lambda r: _u64(r[0]))
        chunks = self._chunk(rows)
        metas, written = [], 0
        try:
            for chunk in chunks:
                meta = self._encode_and_write("spill_write", chunk)
                metas.append(meta)
                written += meta["bytes"]
        except Exception as e:  # noqa: BLE001 - storage exhausted retries
            # unregistered chunk files are orphans cleanup_spill_runs owns
            self._degrade("spill write", e)
            self._skip_spills = 16
            return False
        self.runs.extend(metas)
        self.stats.bytes_total += written
        self.stats.runs_written += len(metas)
        self.tombstones.pop(partition, None)
        self._announce_spill({"table": self.table, "partition": partition,
                              "rows": len(items), "bytes": written})
        self._maybe_compact(partition)
        return True

    def _ts_of_packed(self, packed) -> int:
        # packed payloads carry their event time at index -1 by the
        # operator pack contract; tolerate anything else with ts=0
        try:
            return int(packed[-1])
        except Exception:  # noqa: BLE001
            return 0

    def _chunk(self, rows: list) -> list[list]:
        out, cur, size = [], [], 0
        for r in rows:
            cur.append(r)
            size += len(r[1]) + 32
            if size >= self.target_file_bytes:
                out.append(cur)
                cur, size = [], 0
        if cur:
            out.append(cur)
        return out

    def _encode_and_write(self, site: str, rows: list) -> dict:
        keys = np.array([_u64(h) for h, _p, _t, _d in rows], dtype=np.uint64)
        ts = np.array([t for _h, _p, t, _d in rows], dtype=np.int64)
        dead = np.array([d for _h, _p, _t, d in rows], dtype=bool)
        vals = np.empty(len(rows), dtype=object)
        for j, (_h, p, _t, _d) in enumerate(rows):
            vals[j] = p
        name = self._run_name(self.next_seq)
        self._write_run(site, name, {
            "_key": keys, "__ts": ts, "__dead": dead, "__val": vals})
        self.next_seq += 1
        nbytes = int(sum(len(p) + 32 for _h, p, _t, _d in rows))
        alive_ts = ts[~dead]
        return {
            "file": name, "seq": self.next_seq - 1,
            "writer": self.task_info.subtask_index, "epoch": self.epoch,
            "gen": 0, "rows": int((~dead).sum()), "bytes": nbytes,
            "min_key": int(keys.min()), "max_key": int(keys.max()),
            "min_ts": int(alive_ts.min()) if len(alive_ts) else 0,
            "max_ts": int(alive_ts.max()) if len(alive_ts) else 0,
            "alive_min_ts": int(alive_ts.min()) if len(alive_ts) else None,
            "bloom": BloomFilter.build(keys).state(),
        }

    # -- compaction --------------------------------------------------------

    def _partition_span(self, partition: int) -> tuple[int, int]:
        width = 2 ** 64 // self.pc
        return partition * width, (partition + 1) * width - 1

    def _maybe_compact(self, partition: int) -> None:
        if self._skip_compacts > 0:
            self._skip_compacts -= 1
            return
        lo, hi = self._partition_span(partition)
        group = [r for r in self.runs
                 if r["min_key"] >= lo and r["max_key"] <= hi]
        if len(group) <= self.max_runs:
            return
        self.compact_partition(partition)

    def compact_partition(self, partition: int) -> bool:
        """Merge every run contained in one partition's key span into a
        single newest-wins generation: dead keys normally fold out
        entirely (every copy is inside the merge set); when a legacy run
        OUTSIDE the merge set still overlaps this span (a
        partition-count change across restores), dead markers are carried
        so they keep shadowing those older copies. Rows outside this
        subtask's key range drop (a rescale peer referencing the old
        files keeps them alive until GC). Old files are left for
        ``cleanup_spill_runs`` — older epochs' manifests still reference
        them."""
        lo, hi = self._partition_span(partition)
        group = [r for r in self.runs
                 if r["min_key"] >= lo and r["max_key"] <= hi]
        if len(group) < 2:
            return False
        group_ids = {id(r) for r in group}
        keep_dead = any(id(r) not in group_ids and _zone_overlaps(r, lo, hi)
                        for r in self.runs)
        best: dict[int, tuple[bytes, int, bool]] = {}
        seen: set[int] = set()
        gen = max(int(r.get("gen", 0)) for r in group) + 1
        try:
            # group preserves self.runs order, so reversed(group) is the
            # newest-first merge order
            for meta in reversed(group):
                cols = self._read_run(meta)
                rk = np.asarray(cols["_key"], dtype=np.uint64)
                dead_col = np.asarray(cols["__dead"], dtype=bool)
                ts = np.asarray(cols["__ts"], dtype=np.int64)
                vals = cols["__val"]
                in_range = (rk >= np.uint64(self.key_lo)) & \
                    (rk <= np.uint64(self.key_hi))
                for j in np.flatnonzero(in_range).tolist():
                    h = _i64(rk[j])
                    if h in seen:
                        continue
                    seen.add(h)
                    if not dead_col[j]:
                        best[h] = (vals[j], int(ts[j]), False)
                    elif keep_dead:
                        best[h] = (b"", 0, True)
            rows = [(h, p, t, d)
                    for h, (p, t, d) in sorted(best.items(),
                                               key=lambda kv: _u64(kv[0]))]
            metas = []
            for chunk in self._chunk(rows) if rows else []:
                m = self._encode_and_write("spill_compact", chunk)
                m["gen"] = gen
                metas.append(m)
        except Exception as e:  # noqa: BLE001 - keep the old runs: correct,
            # just more read amplification until the next attempt succeeds
            self._degrade("spill compaction", e)
            self._skip_compacts = 16
            return False
        self.runs = [r for r in self.runs if id(r) not in group_ids] + metas
        self.stats.compactions += 1
        return True

    # -- expiry ------------------------------------------------------------

    def scan_expired(self, cutoff: int,
                     exclude: Iterable[int]) -> list[tuple[int, object]]:
        """Every cold key whose NEWEST copy has ts < cutoff, promoted
        (tombstoned) so the caller can evict it exactly like a hot key.
        Zone-map gated: no file is read until the watermark actually
        passes the oldest surviving spilled row."""
        if not self.runs:
            return []
        alive_floor = min(
            (r["alive_min_ts"] for r in self.runs
             if r.get("alive_min_ts") is not None and r["rows"]),
            default=None)
        if alive_floor is None or alive_floor >= cutoff:
            return []
        exclude = set(exclude)
        seen: set[int] = set()
        expired: list[tuple[int, object]] = []
        for meta in reversed(self.runs):  # newest copy decides liveness
            # rows==0 runs (pure dead markers — a tombstone-only spill or a
            # chunk split that isolated the trailing dead rows) MUST still
            # be read: their markers shadow older alive copies, exactly
            # like they do on the lookup path
            cols = self._read_run(meta)
            rk = np.asarray(cols["_key"], dtype=np.uint64)
            dead_col = np.asarray(cols["__dead"], dtype=bool)
            ts = np.asarray(cols["__ts"], dtype=np.int64)
            vals = cols["__val"]
            in_range = (rk >= np.uint64(self.key_lo)) & \
                (rk <= np.uint64(self.key_hi))
            surviving_ts = []
            for j in np.flatnonzero(in_range).tolist():
                h = _i64(rk[j])
                if h in seen:
                    continue
                seen.add(h)
                if dead_col[j] or h in exclude or \
                        h in self.tombstones.get(self.partition_of(h), ()):
                    continue
                if int(ts[j]) < cutoff:
                    expired.append((h, loads_values(vals[j])))
                else:
                    surviving_ts.append(int(ts[j]))
            meta["alive_min_ts"] = min(surviving_ts) if surviving_ts else None
        expired.sort(key=lambda kv: _u64(kv[0]))
        for h, _v in expired:
            self.tombstones.setdefault(self.partition_of(h), set()).add(h)
        return expired

    # -- checkpoint / restore ---------------------------------------------

    def manifest(self) -> dict:
        return {
            "v": 1, "kind": "keyed", "pc": self.pc,
            "writer": self.task_info.subtask_index,
            "parallelism": self.task_info.parallelism,
            "clock": self.clock, "next_seq": self.next_seq,
            "last_access": dict(self.last_access),
            "tombstones": {p: sorted(s, key=_u64)
                           for p, s in self.tombstones.items() if s},
            "runs": [{k: v for k, v in r.items() if k != "__bloom_obj"}
                     for r in self.runs],
        }

    def adopt(self, manifests: list[dict]) -> None:
        """Rebuild the cold tier from checkpointed manifest(s): own entry
        on a plain restore, every overlapping peer entry on a rescale.
        Runs are adopted when their key zone overlaps our range; tombstone
        sets union (disjoint key ranges make that exact); clocks take the
        max so post-restore eviction picks the same victims."""
        by_file: dict[str, dict] = {}
        order: list[tuple[tuple, str]] = []
        for m in manifests:
            if not m or m.get("kind") != "keyed":
                continue
            self.clock = max(self.clock, int(m.get("clock", 0)))
            for p, c in (m.get("last_access") or {}).items():
                p = int(p)
                self.last_access[p] = max(self.last_access.get(p, 0), int(c))
            for p, ks in (m.get("tombstones") or {}).items():
                self.tombstones.setdefault(int(p), set()).update(ks)
            for r in m.get("runs") or ():
                if not _zone_overlaps(r, self.key_lo, self.key_hi):
                    continue
                if r["file"] not in by_file:
                    by_file[r["file"]] = dict(r)
                    order.append(((int(r.get("writer", 0)),
                                   int(r.get("seq", 0))), r["file"]))
            if int(m.get("writer", -1)) == self.task_info.subtask_index:
                self.next_seq = max(self.next_seq, int(m.get("next_seq", 1)))
        order.sort()
        self.runs = [by_file[f] for _k, f in order]
        for r in self.runs:
            if int(r.get("writer", -1)) == self.task_info.subtask_index:
                self.next_seq = max(self.next_seq, int(r.get("seq", 0)) + 1)


# ------------------------------------------------------------- row annex


class RowSpillAnnex(_AnnexBase):
    """Cold tier for multiset row state (many rows per key, each row a
    mutable (match_count, null_emitted, values...) record) — the shape of
    ``JoinWithExpiration``'s side stores.

    Runs are immutable; a probed row PROMOTES back into the live store and
    its file slot joins the run's dead-row set (persisted in the manifest,
    the file itself is never rewritten). Expiry marks rows dead in place
    and drops a run once nothing in it is alive."""

    def __init__(self, task_info, storage_url: str, table: str, n_vals: int,
                 stats: Optional[SpillStats] = None):
        super().__init__(task_info, storage_url, table, stats)
        self.n_vals = n_vals
        self.runs: list[dict] = []  # each meta carries "dead": set[int]

    def has_runs(self) -> bool:
        return bool(self.runs)

    def alive_rows(self) -> int:
        return sum(max(0, int(r["rows"]) - len(r["dead"])) for r in self.runs)

    def oldest_ts(self) -> Optional[int]:
        floors = [r["alive_min_ts"] for r in self.runs
                  if r.get("alive_min_ts") is not None]
        return min(floors) if floors else None

    def spill_rows(self, keys: np.ndarray, ts: np.ndarray,
                   match_count: np.ndarray, null_emitted: np.ndarray,
                   vals: list[np.ndarray]) -> bool:
        """Write the given live rows as run file(s); True when durable (the
        caller then kills them from the live store), False to keep them
        resident (backoff or a degraded write)."""
        if self._skip_spills > 0:
            self._skip_spills -= 1
            return False
        if not len(keys):
            return True
        order = np.lexsort((np.arange(len(keys)),
                            keys.astype(np.int64).view(np.uint64)))
        keys_u = keys.astype(np.int64).view(np.uint64)[order]
        ts_s = np.asarray(ts, dtype=np.int64)[order]
        mc_s = np.asarray(match_count, dtype=np.int64)[order]
        ne_s = np.asarray(null_emitted, dtype=bool)[order]
        vals_s = [np.asarray(v, dtype=object)[order] for v in vals]
        # chunk by the per-row floor estimate the state gauges use
        per_row = 8 * (3 + self.n_vals) + 2 + 64
        rows_per_file = max(1, self.target_file_bytes // per_row)
        metas, written = [], 0
        try:
            for lo in range(0, len(keys_u), rows_per_file):
                hi = min(len(keys_u), lo + rows_per_file)
                name = self._run_name(self.next_seq)
                cols = {"_key": keys_u[lo:hi], "__ts": ts_s[lo:hi],
                        "__mc": mc_s[lo:hi], "__ne": ne_s[lo:hi]}
                for i, v in enumerate(vals_s):
                    cols[f"__v{i}"] = v[lo:hi]
                self._write_run("spill_write", name, cols)
                self.next_seq += 1
                nbytes = (hi - lo) * per_row
                metas.append({
                    "file": name, "seq": self.next_seq - 1,
                    "writer": self.task_info.subtask_index,
                    "epoch": self.epoch, "gen": 0, "rows": hi - lo,
                    "bytes": nbytes,
                    "min_key": int(keys_u[lo:hi].min()),
                    "max_key": int(keys_u[lo:hi].max()),
                    "min_ts": int(ts_s[lo:hi].min()),
                    "max_ts": int(ts_s[lo:hi].max()),
                    "alive_min_ts": int(ts_s[lo:hi].min()),
                    "bloom": BloomFilter.build(keys_u[lo:hi]).state(),
                    "dead": set(),
                })
                written += nbytes
        except Exception as e:  # noqa: BLE001
            self._degrade("spill write", e)
            self._skip_spills = 16
            return False
        self.runs.extend(metas)
        self.stats.bytes_total += written
        self.stats.runs_written += len(metas)
        self._announce_spill({"table": self.table, "rows": int(len(keys_u)),
                              "bytes": written})
        return True

    def probe(self, keys: np.ndarray) -> Optional[tuple]:
        """Promote every alive spilled row whose key appears in ``keys``:
        returns (keys, ts, match_count, null_emitted, vals...) arrays for
        the caller to append into its live store (slots marked dead here).
        None when nothing matched."""
        self.stats.probes += 1
        if not self.runs or not len(keys):
            self.stats.probe_files.observe(0)
            return None
        want = np.unique(np.asarray(keys, dtype=np.int64).view(np.uint64))
        lo, hi = int(want.min()), int(want.max())
        out_k, out_t, out_m, out_n = [], [], [], []
        out_v: list[list] = [[] for _ in range(self.n_vals)]
        files = 0
        drop: list[dict] = []
        for meta in self.runs:
            if len(meta["dead"]) >= meta["rows"]:
                continue
            if not _zone_overlaps(meta, lo, hi):
                continue
            if not self._bloom(meta).contains(want).any():
                continue
            files += 1
            cols = self._read_run(meta)
            rk = np.asarray(cols["_key"], dtype=np.uint64)
            alive = np.ones(len(rk), dtype=bool)
            if meta["dead"]:
                alive[sorted(meta["dead"])] = False
            m = alive & np.isin(rk, want) & \
                (rk >= np.uint64(self.key_lo)) & (rk <= np.uint64(self.key_hi))
            idx = np.flatnonzero(m)
            if not len(idx):
                continue
            out_k.append(rk[idx].view(np.int64))
            out_t.append(np.asarray(cols["__ts"], dtype=np.int64)[idx])
            out_m.append(np.asarray(cols["__mc"], dtype=np.int64)[idx])
            out_n.append(np.asarray(cols["__ne"], dtype=bool)[idx])
            for i in range(self.n_vals):
                out_v[i].append(np.asarray(cols[f"__v{i}"],
                                           dtype=object)[idx])
            meta["dead"].update(idx.tolist())
            self._refresh_floor(meta, cols)
            if len(meta["dead"]) >= meta["rows"]:
                drop.append(meta)
        self.stats.probe_files.observe(files)
        for meta in drop:
            self.runs.remove(meta)
        if not out_k:
            return None
        self.stats.promotions += 1
        return (np.concatenate(out_k), np.concatenate(out_t),
                np.concatenate(out_m), np.concatenate(out_n),
                [np.concatenate(v) for v in out_v])

    def _refresh_floor(self, meta: dict, cols: dict) -> None:
        ts = np.asarray(cols["__ts"], dtype=np.int64)
        rk = np.asarray(cols["_key"], dtype=np.uint64)
        alive = np.ones(len(ts), dtype=bool)
        if meta["dead"]:
            alive[sorted(meta["dead"])] = False
        alive &= (rk >= np.uint64(self.key_lo)) & \
            (rk <= np.uint64(self.key_hi))
        meta["alive_min_ts"] = int(ts[alive].min()) if alive.any() else None

    def expire(self, cutoff: int) -> int:
        """Kill every alive spilled row older than the retention cutoff;
        returns the count (the caller's expired/late accounting). Whole
        runs below the cutoff drop without a read when their row count is
        exact; straddling runs are read and marked."""
        dropped = 0
        keep: list[dict] = []
        for meta in self.runs:
            floor = meta.get("alive_min_ts")
            if floor is None or floor >= cutoff:
                keep.append(meta)
                continue
            if meta["max_ts"] < cutoff and not meta["dead"] and \
                    self.key_lo == 0 and self.key_hi == int(_U64):
                dropped += meta["rows"]  # whole run, sole owner: no read
                continue
            cols = self._read_run(meta)
            ts = np.asarray(cols["__ts"], dtype=np.int64)
            rk = np.asarray(cols["_key"], dtype=np.uint64)
            alive = np.ones(len(ts), dtype=bool)
            if meta["dead"]:
                alive[sorted(meta["dead"])] = False
            alive &= (rk >= np.uint64(self.key_lo)) & \
                (rk <= np.uint64(self.key_hi))
            hit = alive & (ts < cutoff)
            dropped += int(hit.sum())
            meta["dead"].update(np.flatnonzero(hit).tolist())
            self._refresh_floor(meta, cols)
            if len(meta["dead"]) < meta["rows"]:
                keep.append(meta)
        self.runs = keep
        return dropped

    # -- checkpoint / restore ---------------------------------------------

    def manifest(self) -> dict:
        runs = []
        for r in self.runs:
            m = {k: v for k, v in r.items() if k not in ("dead", "__bloom_obj")}
            m["dead"] = sorted(r["dead"])
            runs.append(m)
        return {"v": 1, "kind": "rows", "writer": self.task_info.subtask_index,
                "parallelism": self.task_info.parallelism,
                "next_seq": self.next_seq, "runs": runs}

    def adopt(self, manifests: list[dict]) -> None:
        by_file: dict[str, dict] = {}
        order: list[tuple[tuple, str]] = []
        for m in manifests:
            if not m or m.get("kind") != "rows":
                continue
            for r in m.get("runs") or ():
                if not _zone_overlaps(r, self.key_lo, self.key_hi):
                    continue
                if r["file"] in by_file:
                    by_file[r["file"]]["dead"].update(r.get("dead") or ())
                else:
                    meta = dict(r)
                    meta["dead"] = set(r.get("dead") or ())
                    by_file[r["file"]] = meta
                    order.append(((int(r.get("writer", 0)),
                                   int(r.get("seq", 0))), r["file"]))
            if int(m.get("writer", -1)) == self.task_info.subtask_index:
                self.next_seq = max(self.next_seq, int(m.get("next_seq", 1)))
        order.sort()
        self.runs = [by_file[f] for _k, f in order]
        shared = len(manifests) > 1
        for r in self.runs:
            if shared:
                # a rescale may share one run between subtasks, and the
                # persisted floor was computed under the OLD owner's key
                # range (rows alive in OUR slice may sit below it, or the
                # old owner's slice may be fully dead with ours alive) —
                # reset to the run's global min_ts, the conservative bound;
                # the first probe/expire read recomputes the exact
                # per-range floor
                r["alive_min_ts"] = r["min_ts"]
            if int(r.get("writer", -1)) == self.task_info.subtask_index:
                self.next_seq = max(self.next_seq, int(r.get("seq", 0)) + 1)


# --------------------------------------------- manifest table convention


def checkpoint_manifest(ctx, table: str, annex) -> None:
    """Persist an annex's manifest into its ``<base>__spill`` global table
    (one entry per subtask, like ``persist_mark``). Spilled runs are
    referenced by name, never re-uploaded — ``TableManager.checkpoint``
    lifts the run list into the file metadata so checkpoint GC can see
    which run files are still live. The ``__spill`` suffix is a hard
    convention: the state auditor (LR203) and the GC both key on it."""
    ctx.table_manager.global_keyed(table).insert(
        ctx.task_info.subtask_index, annex.manifest())


def require_spill_for_manifest(ctx, table: str) -> None:
    """Guard for operators restoring WITHOUT spilling enabled: if the
    checkpoint's ``<base>__spill`` manifest still references runs, most of
    the keyspace lives in files only the annex can read — restoring hot
    rows alone would silently re-aggregate those keys from identity.
    Failing the restore is the honest outcome; re-enable
    ``state.spill.enabled`` (or compact the state back resident first)."""
    # endswith: a chained member's tables restore under a "c{i}." prefix
    for name, tbl in ctx.table_manager.globals.items():
        if not name.endswith(table):
            continue
        runs = manifest_run_files(tbl.data)
        if runs:
            raise RuntimeError(
                f"checkpoint manifest {name!r} references {len(runs)} "
                "spilled run file(s) but state.spill.enabled is false: "
                "restoring only the hot rows would silently discard the "
                "cold keyspace — re-enable state.spill.enabled to restore "
                "this job")


def restore_manifest(ctx, table: str) -> list[dict]:
    """Manifest entries for an annex restore: our OWN subtask's entry when
    the snapshot was taken at our parallelism (same key range, exact
    restore); EVERY peer entry on a rescale — a new subtask's range can
    straddle several old subtasks' manifests, and the adopting annex
    filters runs by key-range overlap."""
    ti = ctx.task_info
    tbl = ctx.table_manager.global_keyed(table)
    own = tbl.get(ti.subtask_index)
    if isinstance(own, dict) and \
            int(own.get("parallelism", -1)) == ti.parallelism:
        return [own]
    return [v for _k, v in sorted(tbl.items()) if v is not None]


def manifest_run_files(table_data: dict) -> list[str]:
    """Run file names referenced by a ``__spill`` table's manifest entries
    (checkpoint metadata + GC)."""
    out = set()
    for m in table_data.values():
        if isinstance(m, dict):
            for r in m.get("runs") or ():
                if isinstance(r, dict) and r.get("file"):
                    out.add(r["file"])
    return sorted(out)


# ------------------------------------------------------------------- GC


def cleanup_spill_runs(storage_url: str, job_id: str,
                       newest_complete_epoch: int) -> int:
    """Delete spill run files no surviving checkpoint references. Runs
    created at-or-after the newest complete epoch are always kept: they may
    be fresh post-checkpoint files the next manifest will reference (their
    epoch tag is embedded in the file name). Returns files removed."""
    base = os.path.join(storage_url, job_id, "spill")
    if not storage.isdir(base):
        return 0
    referenced: set[tuple[str, str]] = set()
    ckpt_base = os.path.join(storage_url, job_id, "checkpoints")
    if storage.isdir(ckpt_base):
        for cp in storage.listdir(ckpt_base):
            cdir = os.path.join(ckpt_base, cp)
            if not cp.startswith("checkpoint-") or not storage.isdir(cdir):
                continue
            for opd in storage.listdir(cdir):
                if not opd.startswith("operator-"):
                    continue
                for fn in storage.listdir(os.path.join(cdir, opd)):
                    if not (fn.startswith("metadata-") and
                            fn.endswith(".json")):
                        continue
                    import json as _json

                    try:
                        meta = _json.loads(storage.read_text(
                            os.path.join(cdir, opd, fn)))
                    except Exception:  # noqa: BLE001 - torn metadata: skip
                        continue
                    for fm in meta.get("files", ()):
                        for rf in fm.get("spill_runs", ()):
                            referenced.add((opd, rf))
    removed = 0
    for opd in storage.listdir(base):
        d = os.path.join(base, opd)
        if not opd.startswith("operator-") or not storage.isdir(d):
            continue
        for fn in storage.listdir(d):
            m = _RUN_NAME_RE.match(fn)
            if m is None:
                continue
            if int(m.group(2)) >= newest_complete_epoch:
                continue
            if (opd, fn) in referenced:
                continue
            try:
                storage.remove(os.path.join(d, fn))
                removed += 1
            except FileNotFoundError:
                pass
    return removed
