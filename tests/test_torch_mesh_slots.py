"""The key-sharded mesh over several device slots (arroyo_tpu_torch
device.py's placement, parallel/mesh.py's slots and exchange), on the CPU.

- The placement rule as a pure function: n shards split into contiguous
  runs over k slots (sizes differ by at most one), the default (an
  index-less ``cuda``: the first min(n, cards) cards, the counterpart of
  ``jax.devices()[:n]``; a named card or the CPU: one slot), a list or a
  comma-separated string (the environment layer), and a slot naming a card
  the machine lacks raising.
- The exchange across slots (one slot among them) against the one-device
  transposing copy, one field and a step's fields in one call.
- The kernel wrappers launch on their tensors' card: a mock library records
  the device index each C entry is called with, for tensors that report
  cards 1 and 3 while the thread's current device is never asked.
- Nexmark q7 through the engine with ``device.mesh-placement`` four CPU
  slots, fused and on the host path, against the JAX package's mesh on its
  8 emulated devices and the oracle; and a checkpoint at 4 shards in 2
  slots restored at 8 shards in 4.

The store-level cases (state after every step, closes, the hot key, the
spill, max_probes 0 and -1, snapshots across placements and the 4 -> 8
resize, at 1, 2, 3, 4 and 8 slots) are tests/test_torch_sharded_agg.py's
``slots`` tests. Exact throughout.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import pytest
import torch

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu_torch.device import mesh_slot_devices, placement_devices, split_shards
from arroyo_tpu_torch.engine import segment as tseg
from arroyo_tpu_torch.ops import kernels, sharded_kernels as sk
from arroyo_tpu_torch.parallel import Mesh, all_to_all, can_make, make_mesh
from arroyo_tpu_torch.parallel import exchange as slot_exchange
from arroyo_tpu_torch.parallel import sharded_agg as tsharded

from test_torch_checkpoint_queries import MODULES, _engine
from test_torch_mesh_fused import _assert_compiled, _need_devices, _run_both
from test_torch_q7 import build_q7, oracle_q7, windows

CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


# ---------------------------------------------------------------- placement


@pytest.mark.parametrize("n,k,sizes", [
    (8, 1, [8]), (8, 2, [4, 4]), (8, 3, [3, 3, 2]), (8, 4, [2, 2, 2, 2]),
    (8, 8, [1] * 8), (4, 3, [2, 1, 1]), (5, 2, [3, 2]), (32, 5, [7, 7, 6, 6, 6])])
def test_split_shards_contiguous_sizes_within_one(n, k, sizes):
    runs = split_shards(n, k)
    assert [hi - lo for lo, hi in runs] == sizes
    assert runs[0][0] == 0 and runs[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))


@pytest.mark.parametrize("n,k", [(4, 5), (1, 2), (3, 0)])
def test_split_shards_refuses_empty_slots(n, k):
    with pytest.raises(ValueError):
        split_shards(n, k)


@pytest.mark.parametrize("device,n,cards,want", [
    (CUDA, 8, 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (CUDA, 8, 1, ["cuda:0"]),
    (CUDA, 2, 4, ["cuda:0", "cuda:1"]),
    (torch.device("cuda", 2), 8, 4, ["cuda:2"]),
    (torch.device("cpu"), 8, 4, ["cpu"]),
])
def test_default_placement(device, n, cards, want):
    """None: an index-less cuda takes the first min(n, cards) cards; a named
    card or the CPU is one slot."""
    assert [str(d) for d in placement_devices(n, device, None, cards)] == want


@pytest.mark.parametrize("placement,want", [
    (["cuda:0"] * 4, ["cuda:0"] * 4),
    ("cuda:1,cuda:0", ["cuda:1", "cuda:0"]),
    (" cuda:3 , cuda ", ["cuda:3", "cuda:2"]),  # an index-less card: the current one
    (["cpu", "cpu", "cpu"], ["cpu"] * 3),
])
def test_named_placement(placement, want):
    got = placement_devices(8, torch.device("cpu"), placement, card_count=4, current=2)
    assert [str(d) for d in got] == want


@pytest.mark.parametrize("placement,err", [
    (["cuda:4"], "has 4 CUDA card"),
    ("cuda:0,cuda:7", "has 4 CUDA card"),
    (["cpu", "cuda:0"], "mix the CPU and CUDA"),
    (["cpu"] * 9, "9 mesh slots for 8 shards"),
    ([], "names no slot"),
])
def test_bad_placement_raises(placement, err):
    """A slot on a card the machine lacks raises; nothing falls back."""
    with pytest.raises(ValueError, match=err):
        placement_devices(8, torch.device("cpu"), placement, card_count=4)


def test_no_card_for_the_default_raises():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        placement_devices(8, CUDA, None, card_count=0)


def test_placement_from_the_config_and_the_environment(monkeypatch):
    """``device.mesh-placement`` as a TOML-like list through update(), and
    as the comma-separated string the environment layer gives."""
    tcfg.update({"device.mesh-placement": ["cpu", "cpu"]})
    assert [str(d) for d in mesh_slot_devices(4, "cpu")] == ["cpu", "cpu"]
    tcfg.reset()
    monkeypatch.setenv("ARROYO_TPU_TORCH__DEVICE__MESH_PLACEMENT", "cpu,cpu,cpu")
    monkeypatch.setenv("ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE", "cpu")
    assert tcfg.config().get("device.mesh-placement") == "cpu,cpu,cpu"
    mesh = make_mesh(8)
    assert [(s.lo, s.hi) for s in mesh.slots] == [(0, 3), (3, 6), (6, 8)]
    assert all(s.stream is None and s.device.type == "cpu" for s in mesh.slots)
    assert can_make(8) and not can_make(2)  # three slots cannot hold two shards


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_cuda_placement_without_cuda_raises():
    with pytest.raises(RuntimeError, match="not available"):
        make_mesh(8, "cpu", placement=["cuda:0", "cuda:0"])
    tcfg.update({"device.mesh-placement": "cuda:0,cuda:1"})
    assert not can_make(8)


def test_one_slot_is_the_old_mesh():
    mesh = make_mesh(8, "cpu")
    assert len(mesh.slots) == 1 and mesh.slots[0] == (torch.device("cpu"), None, 0, 8)
    assert mesh.device == torch.device("cpu") and mesh.n == 8
    assert repr(mesh) == "Mesh(8 shards on cpu, axis 'data')"


# ---------------------------------------------------------------- exchange


@pytest.mark.parametrize("n,k", [(4, 2), (4, 3), (8, 3), (8, 4), (8, 8), (5, 2), (4, 1), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.bool, torch.float64])
def test_slot_exchange_is_the_transposing_copy(n, k, dtype):
    """Each source slot's block for a destination slot's shards lands at the
    source's shard positions: ``[src, dst * dc + j] -> [dst, src * dc + j]``
    across slots, into the head of wider merged rows."""
    dc, tail = 3, 5
    gen = torch.Generator().manual_seed(n * 100 + k)
    x = torch.randint(-1000, 1000, (n, n * dc), generator=gen).to(dtype)
    want = all_to_all(x)
    mesh = Mesh(n, torch.device("cpu"), slot_devices=[torch.device("cpu")] * k)
    sends = [x[s.lo:s.hi].clone() for s in mesh.slots]
    merged = [torch.zeros((s.n, n * dc + tail), dtype=dtype) for s in mesh.slots]
    slot_exchange(mesh, [[x] for x in sends], [[m[:, :n * dc]] for m in merged])
    got = torch.cat(merged)
    assert torch.equal(got[:, :n * dc], want)
    assert not got[:, n * dc:].any()  # the kept-local tail is not touched


@pytest.mark.parametrize("n,k", [(8, 1), (8, 3), (8, 4)])
def test_slot_exchange_moves_every_field_at_once(n, k):
    """One call moves a step's fields (key, bin, valid and lanes of their
    own dtypes): each field equals its own transposing copy."""
    dc = 4
    rng = np.random.default_rng(n * 10 + k)
    dts = [torch.int64, torch.int32, torch.bool, torch.float64, torch.int64]
    xs = [torch.from_numpy(rng.integers(0, 1 << 20, (n, n * dc))).to(dt) for dt in dts]
    mesh = Mesh(n, torch.device("cpu"), slot_devices=[torch.device("cpu")] * k)
    sends = [[x[s.lo:s.hi].clone() for x in xs] for s in mesh.slots]
    recvs = [[torch.zeros((s.n, n * dc), dtype=dt) for dt in dts] for s in mesh.slots]
    slot_exchange(mesh, sends, recvs)
    for f, x in enumerate(xs):
        assert torch.equal(torch.cat([r[f] for r in recvs]), all_to_all(x))


# ---------------------------------------------------------------- wrappers


class _Card(torch.Tensor):
    """A CPU tensor that reports card ``card`` (a subclass per card)."""

    card = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__self__", None) is torch._C.TensorBase.device:
            return torch.device("cuda", cls.card)
        if getattr(func, "__name__", "") == "get_device":
            return cls.card
        return super().__torch_function__(func, types, args, kwargs or {})


_CARDS: dict = {}


def on_card(t: torch.Tensor, card: int) -> torch.Tensor:
    cls = _CARDS.setdefault(card, type(f"OnCard{card}", (_Card,), {"card": card}))
    return t.as_subclass(cls)


class _NoCurrentDevice:
    """sharded_kernels' torch.cuda: streams of handle 0; asking the
    thread's current device fails the test."""

    class _Stream:
        cuda_stream = 0

    def current_stream(self, dev=None):
        return self._Stream()

    def current_device(self):
        raise AssertionError("a wrapper asked for the thread's current device")


class _TorchOnCards:
    """sharded_kernels' torch: allocations on a card are CPU tensors that
    report it; everything else is torch's."""

    cuda = _NoCurrentDevice()

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def _alloc(fn, args, kw):
        dev = kw.pop("device", None)
        kw.pop("pin_memory", None)
        t = fn(*args, **kw)
        dev = torch.device(dev) if dev is not None else None
        return on_card(t, dev.index) if dev is not None and dev.type == "cuda" else t

    def empty(self, *a, **kw):
        return self._alloc(torch.empty, a, kw)

    def zeros(self, *a, **kw):
        return self._alloc(torch.zeros, a, kw)

    def full(self, *a, **kw):
        return self._alloc(torch.full, a, kw)


class MockLibrary:
    """csrc/sharded_agg.cu's library: every entry records its name and the
    device index it was given (its first argument) and succeeds; the size
    queries give small sizes and no pinned read-back."""

    SIZES = {"arroyo_agg_sort_reduce_hist_bytes": 0}

    def __init__(self):
        self.calls: list = []

    def __getattr__(self, name):
        if name.endswith(("_bytes", "_words", "_len")):
            return lambda *a: self.SIZES.get(name, 64)
        if name.endswith("_kernel_launches"):
            return lambda *a: 0

        def entry(*args):
            self.calls.append((name, args[0]))
            return 0

        return entry


@pytest.fixture
def mock_library(monkeypatch):
    lib = MockLibrary()
    monkeypatch.setattr(sk, "build_library", lambda: lib)
    monkeypatch.setattr(sk, "torch", _TorchOnCards())
    monkeypatch.setattr(sk, "_claims_cache", {})
    monkeypatch.setattr(sk, "_scratch_cache", {})
    monkeypatch.setattr(kernels, "_stream", lambda dev: ctypes.c_void_p(0))
    return lib


@pytest.mark.parametrize("card", [1, 3])
def test_wrappers_launch_on_their_tensors_card(mock_library, card):
    """K8, K10's exchange, K9, K10's spill and K11 on tensors that report
    ``card``: every C entry is handed that card's index (the tensors' own),
    and none asks the thread's current device; K9's cluster report names
    the card it is asked about."""
    S, L, D, dc, cap, sc = 2, 8, 4, 2, 16, 8
    kinds = ("sum", "count")

    def t(shape, dtype):
        return on_card(torch.zeros(shape, dtype=dtype), card)

    key, bins = t((S, L), torch.int64), t((S, L), torch.int32)
    valid = t((S, L), torch.bool)
    vals = [t((S, L), torch.int64), None]
    sk.agg_sort_reduce(kinds, key, bins, valid, vals, bin_offset=3, n_valid=5)
    acts = [t((S, L), torch.int64), t((S, L), torch.int64)]
    ex = sk.shard_exchange(kinds, key, bins, valid, acts, dc, n_dest=D)
    assert tuple(ex.s_key.shape) == (S, D * dc) and tuple(ex.m_key.shape) == (S, D * dc + L)
    assert ex.s_key.device == torch.device("cuda", card)
    table = (t((S, cap), torch.int64), t((S, cap), torch.int32), t((S, cap), torch.bool),
             [t((S, cap), torch.int64), t((S, cap), torch.int64)])
    still = sk.agg_probe_merge(kinds, table, key, bins, valid, acts, 4)
    spill = (t((S, sc), torch.int64), t((S, sc), torch.int32), t(S, torch.int32),
             [t((S, sc), torch.int64), t((S, sc), torch.int64)], t(S, torch.int32))
    sk.shard_spill(kinds, key, bins, acts, still, spill, sk.spill_scratch(S, L, key.device))
    sk.shard_extract(table, 0, 4, 0, 8)
    assert sk.probe_merge_cluster(torch.device("cuda", card))["device"] == card
    names = [n for n, _ in mock_library.calls]
    assert names == ["arroyo_agg_sort_reduce", "arroyo_shard_exchange", "arroyo_agg_probe_merge",
                     "arroyo_shard_spill", "arroyo_shard_extract",
                     "arroyo_agg_probe_merge_cluster"]
    assert {d for _, d in mock_library.calls} == {card}


def test_dev_index_is_the_tensors_own():
    assert sk._dev_index(on_card(torch.zeros(1), 5)) == 5
    assert sk._card(torch.device("cuda", 2)) == 2


# ---------------------------------------------------------------- engine

Q7_SLOTS = {"device.mesh-devices": 8, "pipeline.chaining.enabled": True,
            "pipeline.source-batch-size": 4096, "device.batch-capacity": 4096,
            "device.table-capacity": 4096, "device.emit-capacity": 2048,
            "segment.compile.min-rows": 1024, "worker.queue-size": 8192}


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "host path"])
def test_q7_over_four_slots_matches_jax_and_oracle(fuse, monkeypatch):
    """q7 with its window in 8 key shards over four CPU slots (2 shards
    each): the rows equal the JAX mesh's in order and the oracle's; the
    fused step runs once per fused micro-batch; the store is the 4-slot
    mesh the placement asked for."""
    _need_devices()
    events = 20_000
    tcfg.update({"device.mesh-placement": ["cpu"] * 4})
    made = []
    real = tsharded.ShardedAggregator.__init__

    def record(self, mesh, *a, **kw):
        made.append(mesh)
        real(self, mesh, *a, **kw)

    monkeypatch.setattr(tsharded.ShardedAggregator, "__init__", record)
    jrows, trows, ledgers = _run_both(
        lambda g, rows: build_q7(g, rows, events), Q7_SLOTS, f"q7slots-{fuse}", fuse)
    assert made and all([(s.lo, s.hi) for s in m.slots] == [(0, 2), (2, 4), (4, 6), (6, 8)]
                        for m in made)
    assert windows(trows) == windows(jrows) == oracle_q7(events)
    assert [b["auction"].tolist() for b in trows] == [b["auction"].tolist() for b in jrows]
    (seg, agg), (jseg_c, jagg) = ledgers["torch"], ledgers["jax"]
    _assert_compiled(f"q7slots-{fuse}-torch", "bids")
    if fuse:
        assert seg["fused"] == agg["fused_steps"] > 0
        assert (seg, agg) == (jseg_c, jagg)
    else:
        assert agg["fused_steps"] == 0 and agg["host_steps"] > 0


def _q7_run(url: str, shards: int, slots: int, restore_epoch=None, polls=None) -> list:
    tcfg.update({**Q7_SLOTS, "device.mesh-devices": shards,
                 "device.mesh-placement": ["cpu"] * slots, "segment.compile.mesh-fuse": True})
    rows: list = []
    eng = _engine("torch", build_q7(MODULES["torch"], rows, EVENTS), "q7slots", url,
                  restore_epoch=restore_epoch)
    if polls is None:
        eng.run_to_completion(timeout=300)
        return rows
    gate = chip_smoke.gate_source(eng, polls)
    eng.start()
    assert gate.reached.wait(120)
    assert eng.checkpoint_and_wait(1, timeout=120, then_stop=True)
    eng.join(timeout=120)
    return rows


EVENTS = 30_000


@pytest.mark.parametrize("before,after", [((4, 2), (8, 4)), ((8, 4), (8, 1))],
                         ids=["4 shards in 2 slots -> 8 in 4", "8 in 4 -> 8 in 1"])
def test_checkpoint_restores_across_slot_counts(before, after, tmp_path):
    """A checkpoint of q7's window taken over one placement restores over
    another (and at another width): the first run's windows and the
    restored run's together are the oracle's."""
    url = str(tmp_path / "ck")
    tseg.reset_mesh_dispatch_counts()
    first = _q7_run(url, *before, polls=4)
    copy = str(tmp_path / "copy")
    shutil.copytree(url, copy)
    rest = _q7_run(copy, *after, restore_epoch=1)
    assert windows(first + rest) == oracle_q7(EVENTS)
    assert tsharded.dispatch_counts()["fused_steps"] > 0
