"""Key-skew sketches: deterministic space-saving top-k over routing hashes
(the port's copy of arroyo_tpu/obs/sketch.py; its state and its pickled
``__sketch`` checkpoint entry are the JAX package's byte for byte).

A skew-adaptive shuffle and the spill backend both need to know WHICH keys
are hot before they can act; the per-operator emit/queue histograms only
say that *something* is hot. This module is the detection layer: a
space-saving heavy-hitter summary fed at the shuffle/key boundaries
(Collector key hashing, keyed window/join inserts via the task run loop),
cheap enough to leave on in production. It works on host (numpy) keys only:
``Batch.keys`` is numpy in the port, so feeding it costs no device sync.

Design constraints, in order:

  deterministic   replay after checkpoint restore must rebuild the same
                  summary — no randomness anywhere. Batch sampling uses a
                  counter whose phase is seeded from the subtask index
                  (decorrelates subtasks) and is part of the checkpointed
                  state, so a restored run resumes the exact sampling
                  cadence the original would have had. At the default
                  ``sample_every=1`` every row is counted exactly once, so
                  the summary is row-deterministic no matter how the
                  coalescing layer re-draws batch boundaries; sampling >1
                  is cheaper but boundary-sensitive (time-based coalesce
                  flushes can shift WHICH batches land on the sampled
                  phase), so it trades exact replay equality for cost.
  cheap           one np.unique per SAMPLED batch (1/``sample_every``),
                  one sort of the summary's and the batch's keys to evict,
                  one dict built from the survivors; skipped batches cost
                  one integer increment. The port does in numpy what the
                  JAX package walks key by key, with the same state, entry
                  order included.
  mergeable       rescale restore can hand one subtask several prior
                  subtasks' summaries; ``merge_state`` implements the
                  standard space-saving merge (absent keys are compensated
                  with the other summary's eviction threshold), so the
                  union never under-counts a heavy hitter.

Counts are over the 64-bit routing hash (``_key``), not the user key value:
that is what exists at every shuffle boundary, and it is enough to detect
and act on skew (split/replicate by hash). ``error`` per entry is the
standard space-saving overestimate bound — ``count - error`` is a
guaranteed lower bound on the key's true traffic.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class KeySketch:
    """Space-saving top-k summary of uint64 routing-hash traffic."""

    __slots__ = ("capacity", "sample_every", "counts", "errors", "threshold",
                 "total", "_tick")

    def __init__(self, capacity: int = 64, sample_every: int = 1,
                 seed: int = 0):
        self.capacity = max(1, int(capacity))
        self.sample_every = max(1, int(sample_every))
        self.counts: dict[int, int] = {}   # key hash -> estimated count
        self.errors: dict[int, int] = {}   # key hash -> overestimate bound
        # max count ever evicted: an absent key may have accumulated up to
        # this much traffic before eviction, so re-entries start from here
        self.threshold = 0
        self.total = 0  # rows represented (sampled rows x sample_every)
        # deterministic sampling phase; the seed (subtask index) decorrelates
        # which batches different subtasks sample without randomness
        self._tick = int(seed) % self.sample_every

    # ------------------------------------------------------------------ feed

    def observe(self, keys: np.ndarray) -> None:
        """Count one batch's routing keys (1/sample_every batches counted;
        the rest cost a single increment)."""
        self._tick += 1
        if self._tick % self.sample_every:
            return
        n = len(keys)
        if n == 0:
            return
        scale = self.sample_every
        self.total += n * scale
        u, c = np.unique(np.asarray(keys, dtype=np.uint64), return_counts=True)
        c = c.astype(np.int64) * scale
        old_k, old_v = self._arrays()
        # the summary's keys the batch holds add to their counts in place;
        # the batch's other keys are new and follow them in ascending order,
        # as the JAX package's per-key walk inserts them
        at = np.minimum(np.searchsorted(u, old_k), len(u) - 1)
        hit = u[at] == old_k
        old_v[hit] += c[at[hit]]
        new = np.ones(len(u), dtype=bool)
        new[at[hit]] = False
        # space-saving entry: a new key inherits the eviction threshold as
        # both starting mass and error bound
        thr = self.threshold
        self._keep_top(np.concatenate([old_k, u[new]]), np.concatenate([old_v, c[new] + thr]),
                       len(old_k), thr)

    def _arrays(self) -> tuple[np.ndarray, np.ndarray]:
        n = len(self.counts)
        return (np.fromiter(self.counts.keys(), dtype=np.uint64, count=n),
                np.fromiter(self.counts.values(), dtype=np.int64, count=n))

    def _evict(self) -> None:
        if len(self.counts) > self.capacity:
            keys, vals = self._arrays()
            self._keep_top(keys, vals, len(keys), 0)

    def _keep_top(self, keys: np.ndarray, vals: np.ndarray, n_old: int, new_error: int) -> None:
        """Make the summary ``keys`` / ``vals`` (its ``n_old`` entries in
        their order, then new ones, each with error ``new_error``) less the
        smallest counts past ``capacity``, ties by key ascending, as the
        JAX package's heapq.nsmallest eviction: the same entries in the same
        order, so the state pickles to the same bytes."""
        keep = np.ones(len(keys), dtype=bool)
        over = len(keys) - self.capacity
        if over > 0:
            gone = np.lexsort((keys, vals))[:over]
            self.threshold = max(self.threshold, int(vals[gone].max()))
            keep[gone] = False
        kept = keys[keep].tolist()
        self.counts = dict(zip(kept, vals[keep].tolist()))
        n_kept_old = int(keep[:n_old].sum())
        old = set(kept[:n_kept_old])
        errors = {k: e for k, e in self.errors.items() if k in old}
        if new_error:
            errors.update(dict.fromkeys(kept[n_kept_old:], new_error))
        self.errors = errors

    # ----------------------------------------------------------------- views

    def topk(self, k: int = 8) -> list[dict]:
        """[{key, count, error, share}] by count desc (ties key asc);
        ``share`` is count/total traffic, ``count - error`` a guaranteed
        lower bound on the key's true rows."""
        order = sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))
        total = self.total or 1
        return [
            {"key": key, "count": cnt, "error": self.errors.get(key, 0),
             "share": round(cnt / total, 4)}
            for key, cnt in order[:k]
        ]

    # ------------------------------------------------------ checkpoint state

    def state(self) -> dict:
        """Plain-python snapshot for the checkpointed ``__sketch`` table."""
        return {
            "counts": dict(self.counts),
            "errors": dict(self.errors),
            "threshold": self.threshold,
            "total": self.total,
            "tick": self._tick,
            "sample_every": self.sample_every,
        }

    def merge_state(self, state: Optional[dict]) -> None:
        """Fold a persisted summary in (restore; rescale may fold several).
        Space-saving merge: keys absent from one side are compensated with
        that side's threshold, so the union never under-counts."""
        if not state:
            return
        other_counts = {int(k): int(v) for k, v in state.get("counts", {}).items()}
        other_errors = {int(k): int(v) for k, v in state.get("errors", {}).items()}
        other_thr = int(state.get("threshold", 0))
        mine = self.counts
        merged_fresh = not mine and not self.total
        for k, v in other_counts.items():
            if k in mine:
                mine[k] += v
                if other_errors.get(k) or self.errors.get(k):
                    self.errors[k] = self.errors.get(k, 0) + other_errors.get(k, 0)
            else:
                mine[k] = v + self.threshold
                err = other_errors.get(k, 0) + self.threshold
                if err:
                    self.errors[k] = err
        if other_thr:
            # keys the other summary evicted may include any of ours: every
            # key absent from it gets its threshold as compensation too
            for k in mine:
                if k not in other_counts:
                    mine[k] += other_thr
                    self.errors[k] = self.errors.get(k, 0) + other_thr
        self.threshold += other_thr
        self.total += int(state.get("total", 0))
        if merged_fresh:
            # restoring our own prior state: resume the exact sampling phase
            self._tick = int(state.get("tick", self._tick))
        self._evict()


def merge_topk(topks, total: int, k: int = 8) -> list[dict]:
    """Merge exported per-subtask top-k lists ([{key, count, error, share}],
    keys already hex-encoded by the metrics export) into one per-operator
    list. Counts for a key absent from some subtask's list are lower bounds
    (that subtask's below-top-k mass is not exported), which is the safe
    direction for skew detection: a key this merge calls hot IS hot.
    ``total`` is the summed per-subtask traffic, for the merged share."""
    counts: dict[str, int] = {}
    errors: dict[str, int] = {}
    for lst in topks:
        for e in lst or ():
            key = e["key"]
            counts[key] = counts.get(key, 0) + int(e["count"])
            err = int(e.get("error", 0))
            if err:
                errors[key] = errors.get(key, 0) + err
    # fixed-width hex sorts lexically == numerically: deterministic ties
    order = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    t = total or 1
    return [{"key": key, "count": c, "error": errors.get(key, 0),
             "share": round(c / t, 4)}
            for key, c in order[:k]]
