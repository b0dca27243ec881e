"""Object stores and parquet state files in the port (state/storage.py,
state/tables.py) against the JAX package's, on tests/test_storage.py's fake
clients: test_storage.py's cases through the port, then checkpoints that
cross the packages both ways over s3:// and gs://, in parquet and in npz.
"""

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import config as jcfg
from arroyo_tpu.state import storage as jstorage
from arroyo_tpu.state import tables as jtables
from arroyo_tpu.types import TaskInfo as JTaskInfo
from arroyo_tpu_torch import faults
from arroyo_tpu_torch.batch import KEY_FIELD, TIMESTAMP_FIELD, Batch
from arroyo_tpu_torch.operators.base import TableSpec
from arroyo_tpu_torch.state import storage
from arroyo_tpu_torch.state import tables as ttables
from arroyo_tpu_torch.types import TaskInfo
from test_storage import FakeGcs, FakeMultipartS3, FakeS3


@pytest.fixture(autouse=True)
def _port_state():
    tcfg.reset()
    tcfg.update({"storage.retry.base-delay-ms": 0})
    storage.reset_retry_state()
    yield
    faults.clear()
    storage.set_s3_client(None)
    storage.set_gcs_client(None)
    jstorage.set_s3_client(None)
    jstorage.set_gcs_client(None)
    tcfg.reset()


@pytest.fixture
def fake_s3():
    client = FakeS3()
    storage.set_s3_client(client)
    jstorage.set_s3_client(client)
    return client


@pytest.fixture
def fake_gcs():
    client = FakeGcs()
    storage.set_gcs_client(client)
    jstorage.set_gcs_client(client)
    return client


@pytest.mark.parametrize("scheme", ["s3", "gs"])
def test_bytes_listing_roundtrip(scheme, fake_s3, fake_gcs):
    """test_storage.py's s3 and gcs listing cases through the port; every
    object the port writes is the JAX package's to read, and back."""
    base = f"{scheme}://bkt/a"
    storage.write_bytes(f"{base}/b/file.bin", b"hello")
    storage.write_text(f"{base}/other.txt", "world")
    assert storage.read_bytes(f"{base}/b/file.bin") == b"hello"
    assert jstorage.read_text(f"{base}/other.txt") == "world"
    jstorage.write_bytes(f"{base}/b/jax.bin", b"from jax")
    assert storage.read_bytes(f"{base}/b/jax.bin") == b"from jax"
    assert storage.exists(f"{base}/other.txt")
    assert not storage.exists(f"{base}/missing")
    assert storage.isdir(base) and storage.isdir(f"{base}/b")
    assert storage.listdir(base) == jstorage.listdir(base) == ["b", "other.txt"]
    assert storage.listdir(f"{base}/b") == ["file.bin", "jax.bin"]
    storage.remove(f"{base}/other.txt")
    assert storage.listdir(base) == ["b"]
    storage.rmtree(base)
    assert not storage.isdir(base) and not jstorage.isdir(base)


def test_missing_s3_client_raises(monkeypatch):
    """Without boto3 and without an injected client an s3:// URL raises,
    naming both ways out; nothing falls back to a local path."""
    import sys

    monkeypatch.setitem(sys.modules, "boto3", None)  # boto3 not installed
    with pytest.raises(RuntimeError, match="boto3.*set_s3_client"):
        storage.write_bytes("s3://bkt/x.bin", b"x")


def test_s3_multipart_write_and_abort():
    """test_storage.py's multipart case through the port: parts reassemble
    byte for byte, a failing part aborts with no object left, parts never go
    below S3's minimum; and the ``storage.multipart`` fault point fails a
    part as the client would."""
    client = FakeMultipartS3()
    storage.set_s3_client(client)
    tcfg.update({"storage.multipart-threshold-bytes": 1024,
                 "storage.multipart-part-size-bytes": 1024})
    small = b"s" * 100
    storage.write_bytes("s3://bkt/small.bin", small)
    assert client.multipart_completed == 0
    big = bytes(range(256)) * 20  # 5 parts of 1024
    storage.write_bytes("s3://bkt/big.bin", big)
    assert client.multipart_completed == 1
    assert storage.read_bytes("s3://bkt/big.bin") == big
    client.fail_part = 3
    with pytest.raises(RuntimeError, match="injected part failure"):
        storage.write_bytes("s3://bkt/fail.bin", big)
    assert client.aborted == 1 and not client.uploads
    assert not storage.exists("s3://bkt/fail.bin")
    client.fail_part = None
    # a transient injected fault at part 2 is retried in place by the
    # storage retry layer: the upload is aborted, then redone whole
    faults.install("storage.multipart:fail_once@part=2", 0)
    storage.write_bytes("s3://bkt/retried.bin", big)
    assert storage.read_bytes("s3://bkt/retried.bin") == big
    assert client.aborted == 2 and client.multipart_completed == 2
    tcfg.update({"storage.multipart-part-size-bytes": None})
    assert storage._multipart_part_size() == storage.S3_MIN_PART


def test_local_write_is_atomic_publish(tmp_path):
    p = str(tmp_path / "x.json")
    storage.write_text(p, "{}")
    assert storage.read_text(p) == "{}"
    assert storage.listdir(str(tmp_path)) == ["x.json"]


def _write_epoch(pkg, url, job, parallelism=2, epoch=1):
    """test_storage.py's checkpoint flow: each subtask a global table and an
    expiring table, then the job marker."""
    tables, TI = (ttables, TaskInfo) if pkg == "torch" else (jtables, JTaskInfo)
    B = Batch if pkg == "torch" else __import__("arroyo_tpu.batch", fromlist=["Batch"]).Batch
    for sub in range(parallelism):
        tm = tables.TableManager(TI(job, "agg", "agg", sub, parallelism), url)
        tm.global_keyed("s").insert(sub, {"offset": 100 + sub})
        keys = (np.arange(4, dtype=np.int64) + 10 * sub).view(np.uint64)
        tm.expiring_time_key("t", retention_micros=10_000_000).insert(B({
            TIMESTAMP_FIELD: np.arange(4, dtype=np.int64) * 1000, KEY_FIELD: keys,
            "v": np.arange(4, dtype=np.int64) + 100 * sub,
            "name": np.array([f"k{sub}", None, "x", "y"], dtype=object)}))
        tm.checkpoint(epoch=epoch, watermark_micros=500)
    tables.write_job_checkpoint_metadata(url, job, epoch)


def _restore(pkg, url, job, epoch=1):
    tables, TI = (ttables, TaskInfo) if pkg == "torch" else (jtables, JTaskInfo)
    tm = tables.TableManager(TI(job, "agg", "agg", 0, 1), url)

    class Spec:
        name = "t"
        retention_micros = 10_000_000

    wm = tm.restore(epoch, [Spec()])
    rows = sorted((int(v), n) for b in tm.expiring_time_key("t").all_batches()
                  for v, n in zip(b["v"], b["name"]))
    return wm, tm.global_keyed("s").get(0), tm.global_keyed("s").get(1), rows


WANT_ROWS = [(0, "k0"), (1, None), (2, "x"), (3, "y"), (100, "k1"), (101, None),
             (102, "x"), (103, "y")]


@pytest.mark.parametrize("codec", ["parquet", "npz"])
@pytest.mark.parametrize("scheme", ["s3", "gs"])
@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("torch", "jax"),
                                           ("jax", "torch")])
def test_checkpoint_crosses_the_packages_in_an_object_store(writer, reader, scheme, codec,
                                                            fake_s3, fake_gcs):
    """A checkpoint written by one package to an object store restores in
    the other (at another parallelism), its state files in either codec;
    the latest complete epoch is found by both."""
    if codec == "parquet":
        pytest.importorskip("pyarrow")
    tcfg.update({"checkpoint.file-format": codec})
    jcfg.update({"checkpoint.file-format": codec})
    url = f"{scheme}://ckpt-bucket/prefix"
    _write_epoch(writer, url, "job1")
    assert ttables.latest_complete_checkpoint(url, "job1") == 1
    assert jtables.latest_complete_checkpoint(url, "job1") == 1
    opdir = ttables.operator_dir(url, "job1", 1, "agg")
    assert f"table-t-000.{codec}" in storage.listdir(opdir)
    assert _restore(reader, url, "job1") == (500, {"offset": 100}, {"offset": 101}, WANT_ROWS)


@pytest.mark.parametrize("scheme", ["s3", "gs"])
def test_compaction_and_fsck_on_an_object_store(scheme, fake_s3, fake_gcs):
    """test_storage.py's compaction case through the port: an epoch
    compacted under an object-store URL restores exactly in both packages,
    and fsck finds nothing wrong with it."""
    from arroyo_tpu_torch.state.integrity import fsck_job

    url = f"{scheme}://ckpt-bucket/c"
    _write_epoch("torch", url, "j", parallelism=3, epoch=2)
    assert ttables.compact_job(url, "j", 2) == 6  # 3 subtasks x 2 tables merged away
    assert not fsck_job(url, "j")
    want = sorted([(v + 100 * s, n) for s in range(3)
                   for v, n in zip(range(4), [f"k{s}", None, "x", "y"])])
    for pkg in ("torch", "jax"):
        assert _restore(pkg, url, "j", epoch=2)[3] == want


def test_checkpoint_roundtrip_on_fake_gcs(fake_gcs):
    tm = ttables.TableManager(TaskInfo("jg", "op", "operator", 0, 1), "gs://ckpt/jobs")
    tm.global_keyed("g").insert("k1", {"x": 1})
    tm.checkpoint(1, None)
    tm2 = ttables.TableManager(TaskInfo("jg", "op", "operator", 0, 1), "gs://ckpt/jobs")
    tm2.restore(1, [TableSpec("g", "global_keyed")])
    assert dict(tm2.global_keyed("g").items())["k1"] == {"x": 1}


def test_npz_checkpoint_readable_when_parquet_default(tmp_path):
    p = str(tmp_path / "table-t-000.npz")
    tcfg.update({"checkpoint.file-format": "npz"})
    ttables.write_columnar(p, {"a": np.arange(5, dtype=np.int64),
                               "s": np.array(["x", None, "y", "z", "w"], dtype=object)})
    tcfg.update({"checkpoint.file-format": "parquet"})
    cols = ttables.read_columnar(p)
    assert list(cols["a"]) == [0, 1, 2, 3, 4]
    assert list(cols["s"]) == ["x", None, "y", "z", "w"]


def test_parquet_heterogeneous_object_column_exact_roundtrip(tmp_path):
    """Mixed python values survive a parquet state file through the pickled
    binary column, in the port and across to the JAX package; a pickle that
    names a class outside builtins and numpy is refused."""
    pytest.importorskip("pyarrow")
    import pickle

    p = str(tmp_path / "table-x-000.parquet")
    vals = np.array([42, "answer", None, 3.5, (1, 2)], dtype=object)
    ttables.write_columnar(p, {"m": vals, "d": np.arange(5, dtype=np.int64)})
    for cols in (ttables.read_columnar(p), jtables.read_columnar(p)):
        assert list(cols["m"]) == [42, "answer", None, 3.5, (1, 2)]
        assert list(cols["d"]) == [0, 1, 2, 3, 4]
    bad = str(tmp_path / "table-y-000.parquet")
    jtables.write_columnar(bad, {"m": np.array([1, "a", TaskInfo], dtype=object)})
    with pytest.raises(pickle.UnpicklingError, match="built-in and numpy values only"):
        ttables.read_columnar(bad)
