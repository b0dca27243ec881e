"""The comparison that decides ``correct`` fails where it should: a whole
run, the chip's look skipped, with the timed path broken underneath once
for each fault the cell can have, and with the control (the reference in
the system's place, one guarantee broken) in the system's place."""

import numpy as np
import pytest

from _cpu import cpu_run


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from arroyo_tpu_torch.ops.slot_agg import SlotAggregator
    from arroyo_tpu_torch.parallel.sharded_agg import ShardedAggregator

    monkeypatch.setattr(SlotAggregator, "_update_chunk", lambda self, *a, **k: None)
    monkeypatch.setattr(ShardedAggregator, "_exchange_merge", lambda self, *a, **k: None)


def half_the_batch(monkeypatch):
    """Half of each batch left out, the aggregate taken over the rest."""
    from arroyo_tpu_torch.ops.slot_agg import SlotAggregator
    from arroyo_tpu_torch.parallel.sharded_agg import ShardedAggregator

    upd, fused = SlotAggregator._update_chunk, ShardedAggregator.update_fused

    def half(self, key_u64, bins, vals):
        h = len(key_u64) // 2
        return upd(self, key_u64[:h], bins[:h], [v if v is None else v[:h] for v in vals])

    monkeypatch.setattr(SlotAggregator, "_update_chunk", half)
    monkeypatch.setattr(ShardedAggregator, "update_fused",
                        lambda self, step, n, base_bin, ontime, arrays:
                        fused(self, step, n // 2, base_bin,
                              None if ontime is None else ontime[: n // 2], arrays))


def no_exchange(monkeypatch):
    """The exchange between the shards' slots left out."""
    import arroyo_tpu_torch.parallel.sharded_agg as sa

    monkeypatch.setattr(sa, "exchange", lambda *a, **k: None)


def answer_altered(monkeypatch):
    """An answer altered where it is produced: each emission's first MAX."""
    from arroyo_tpu_torch.windows.tumbling import TumblingAggregate

    emit = TumblingAggregate._emit_entries

    def altered(self, keys, bins, accs, collector):
        accs = list(accs)
        accs[0] = np.array(accs[0], copy=True)
        accs[0][:1] += 1
        return emit(self, keys, bins, accs, collector)

    monkeypatch.setattr(TumblingAggregate, "_emit_entries", altered)


def emissions_tampered(how):
    """A window's emitted rows lost, repeated, or stamped with a window
    start one width on: each moves a number of its own."""
    def install(monkeypatch):
        from arroyo_tpu_torch.windows.tumbling import TumblingAggregate

        emit = TumblingAggregate._emit_entries
        seen = [0]

        def tampered(self, keys, bins, accs, collector):
            seen[0] += 1
            if seen[0] % 2:
                return emit(self, keys, bins, accs, collector)
            if how == "lost":
                return None
            if how == "repeated":
                emit(self, keys, bins, accs, collector)
            if how == "shifted":
                bins = np.asarray(bins) + 1000
            return emit(self, keys, bins, accs, collector)

        monkeypatch.setattr(TumblingAggregate, "_emit_entries", tampered)

    install.__name__ = f"emission_{how}"
    return install


FAULTS = [("q7.hot", state_unchanged), ("q7.hot", half_the_batch), ("q7.hot", answer_altered),
          ("q7m.hot", state_unchanged), ("q7m.hot", half_the_batch), ("q7m.hot", no_exchange),
          ("q7m.hot", answer_altered),
          ("q7.hot", emissions_tampered("lost")), ("q7.hot", emissions_tampered("repeated")),
          ("q7.hot", emissions_tampered("shifted"))]
MOVES = {"emission_lost": ("windows_missing", "rows_missing"),
         "emission_repeated": ("rows_duplicated",), "emission_shifted": ("windows_extra",)}


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    result, checks, _rec = cpu_run(cell, seed=2**32 + 5, seconds=0.5,
                                   fault=lambda stage: fault(monkeypatch))
    assert not result["correct"]
    assert result["failed"] > 0
    assert any(v > lim for _k, v, lim in checks)
    moved = {k for k, v, lim in checks if v > lim}
    assert set(MOVES.get(fault.__name__, ())) <= moved, moved


@pytest.mark.parametrize("cell", ["q7.hot", "q7m.hot"])
def test_the_control_is_not_correct(cell):
    result, checks, rec = cpu_run(cell, seed=2**32 + 6, seconds=0.5, control="at_least_once")
    assert not result["correct"]
    assert dict((k, v) for k, v, _l in checks)["bids_miscounted"] > 0
    # the same run's own rows, compared beside the control's, are correct
    assert all(v <= lim for _k, v, lim in rec["system_checks"]), rec["system_checks"]


def test_the_same_run_unbroken_is_correct():
    result, _checks, _rec = cpu_run("q7m.hot", seed=2**32 + 5, seconds=0.5)
    assert result["correct"], result["checks"]
