"""repro_torch.serving.wal against repro.serving.wal: records are byte
for byte the reference's, logs cross between the packages, a torn tail
is truncated, group commit batches its barriers.  Then a hypothesis fuzz
after `tests/test_wal_fuzz.py`: a port deployment's log corrupted
anywhere recovers an exact prefix state of the crashed process."""
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.serving import wal as JW
from repro_torch.graph import erdos_renyi, make_labels
from repro_torch.serving import GraphStore, ServingEngine
from repro_torch.serving import wal as W

_MAGIC_LEN = len(b"REPROWAL1\n")


def _records(rng, n=40):
    """A mixed sequence of every record kind, as (kind, version, arrays)."""
    out = []
    for ver in range(1, n + 1):
        kind = int(rng.integers(1, 6))
        if kind == W.EDGES:
            b = int(rng.integers(0, 60))
            out.append(W.WalRecord(
                kind, ver, rng.integers(0, 1000, b).astype(np.int32),
                rng.integers(0, 1000, b).astype(np.int32),
                (rng.random(b, dtype=np.float32) - np.float32(0.5))))
        elif kind == W.LABELS:
            b = int(rng.integers(0, 30))
            out.append(W.WalRecord(kind, ver,
                                   rng.integers(0, 1000, b).astype(np.int64),
                                   rng.integers(-1, 8, b).astype(np.int32)))
        elif kind == W.INDEX:
            out.append(W.WalRecord(kind, ver, rng.random(
                16, dtype=np.float32).reshape(4, 4)))
        else:
            out.append(W.WalRecord(kind, ver))
    return out


def _as_ref(rec):
    return JW.WalRecord(rec.kind, rec.version, rec.a, rec.b, rec.c)


def _equal(a, b):
    assert (a.kind, a.version) == (b.kind, b.version)
    for x, y in ((a.a, b.a), (a.b, b.b), (a.c, b.c)):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.array_equal(np.ravel(x), np.ravel(y))


def _write(mod, path, records, **kw):
    log = mod.WriteAheadLog(path, **kw)
    log.open()
    for r in records:
        if r.kind == W.EDGES:
            log.append_edges(r.version, r.a, r.b, r.c)
        elif r.kind == W.LABELS:
            log.append_labels(r.version, r.a, r.b)
        elif r.kind == W.INDEX:
            log.append_index(r.version, r.a)
        else:
            log.append_marker(r.kind, r.version)
    log.close()


class TestFormat:
    def test_constants_equal_reference(self):
        assert (W.EDGES, W.LABELS, W.COMPACT, W.REBUILD, W.INDEX) == \
            (JW.EDGES, JW.LABELS, JW.COMPACT, JW.REBUILD, JW.INDEX)
        assert W._FILE_MAGIC == JW._FILE_MAGIC

    def test_records_are_byte_equal(self, rng):
        for rec in _records(rng, 200):
            blob = W._encode(rec)
            assert blob == JW._encode(_as_ref(rec))
            _equal(W._decode(blob), JW._decode(blob))

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_logs_cross_between_packages(self, tmp_path, rng, writer):
        recs = _records(rng)
        path = str(tmp_path / "wal-0.log")
        _write(W if writer == "port" else JW, path, recs)
        other = str(tmp_path / "other.log")
        _write(JW if writer == "port" else W, other, recs)
        with open(path, "rb") as f, open(other, "rb") as g:
            assert f.read() == g.read()
        for got in (list(W.read_wal(path)), list(JW.read_wal(path))):
            assert len(got) == len(recs)
            for a, b in zip(got, recs):
                _equal(a, b)

    def test_bad_record_kind_and_bad_file(self, tmp_path):
        with pytest.raises(ValueError, match="unknown WAL record kind"):
            W._encode(W.WalRecord(9, 1))
        log = W.WriteAheadLog(str(tmp_path / "w.log"))
        log.open()
        with pytest.raises(ValueError, match="not a marker"):
            log.append_marker(W.EDGES, 1)
        log.close()
        bad = tmp_path / "bad.log"
        bad.write_bytes(b"NOTAWALFILE\n")
        with pytest.raises(ValueError, match="not a WAL file"):
            W.WriteAheadLog(str(bad)).open()


class TestTornTail:
    @pytest.mark.parametrize("cut", [1, 3, 9, 20])
    def test_torn_tail_truncated_on_open(self, tmp_path, rng, cut):
        recs = _records(rng, 12)
        path = str(tmp_path / "wal.log")
        _write(W, path, recs)
        good = os.path.getsize(path)
        with open(path, "ab") as f:          # a crash mid-append
            f.write(W._HEADER.pack(100, 0) + b"\x01" * (cut - 1))
        log = W.WriteAheadLog(path)
        got = log.open()
        assert os.path.getsize(path) == good
        assert len(got) == len(recs)
        log.append_marker(W.REBUILD, 99)     # appends after the cut
        log.close()
        assert [r.version for r in W.read_wal(path)][-1] == 99

    def test_scan_and_tail(self, tmp_path, rng):
        recs = _records(rng, 10)
        path = str(tmp_path / "wal.log")
        _write(W, path, recs[:6])
        got, off = W.scan_wal(path)
        jgot, joff = JW.scan_wal(path)
        assert off == joff and len(got) == len(jgot) == 6
        log = W.WriteAheadLog(path)
        log.open()
        for r in recs[6:]:
            if r.kind in (W.COMPACT, W.REBUILD):
                log.append_marker(r.kind, r.version)
            elif r.kind == W.EDGES:
                log.append_edges(r.version, r.a, r.b, r.c)
            elif r.kind == W.LABELS:
                log.append_labels(r.version, r.a, r.b)
            else:
                log.append_index(r.version, r.a)
        log.close()
        tail, end = W.tail_records(path, off)
        assert [r.version for r in tail] == [r.version for r in recs[6:]]
        assert end == os.path.getsize(path)
        assert W.tail_records(path, end + 10) == ([], end + 10)


class TestGroupCommit:
    def test_barriers_are_batched(self, tmp_path):
        log = W.WriteAheadLog(str(tmp_path / "w.log"), fsync=True,
                              group_commit_bytes=1 << 30,
                              group_commit_ms=1e9)
        log.open()
        for v in range(1, 6):
            log.append_marker(W.REBUILD, v)
        assert log.pending_appends == 5 and log.fsyncs == 0
        assert log.sync() == 5
        assert log.fsyncs == 1 and log.appends_per_fsync == 5.0
        assert log.sync() == 0 and log.sync_if_due() == 0
        log.close()

    def test_bytes_close_a_group_and_fsync_off_is_inert(self, tmp_path):
        log = W.WriteAheadLog(str(tmp_path / "w.log"), fsync=True,
                              group_commit_bytes=1)
        log.open()
        log.append_marker(W.COMPACT, 1)
        assert log.pending_appends == 0 and log.fsyncs == 1
        log.close()
        off = W.WriteAheadLog(str(tmp_path / "x.log"), group_commit_ms=1)
        assert not off.group_commit


# -- fuzz: a corrupted port deployment recovers an exact prefix state ------

N, K = 60, 4


def _deployment(d, seed):
    g = erdos_renyi(N, 500, seed=7, weighted=True)
    Y = make_labels(N, K, 0.4, np.random.default_rng(7))
    eng = ServingEngine(GraphStore(g, Y, K), num_shards=2, data_dir=d,
                        rebuild_churn=0.2, device="cpu", backend="cuda")
    rng = np.random.default_rng(seed)
    states = {}

    def snap():
        states[(eng.version, eng.epoch, eng.fingerprint())] = \
            eng.Z.numpy().copy()

    snap()
    inserted = []
    for step in range(10):
        if step == 4:
            eng.compact()
        elif step == 7:
            eng.refresh()
        elif step % 3 == 2 and inserted:
            eng.apply_edge_delta(*inserted.pop(), delete=True)
        elif step % 5 == 3:
            nodes = rng.choice(N, int(rng.integers(1, N // 2)),
                               replace=False)
            eng.apply_label_delta(nodes, rng.integers(
                -1, K, nodes.shape[0]).astype(np.int32))
        else:
            b = int(rng.integers(1, 40))
            batch = (rng.integers(0, N, b).astype(np.int32),
                     rng.integers(0, N, b).astype(np.int32),
                     rng.random(b, dtype=np.float32) + 0.5)
            eng.apply_edge_delta(*batch)
            inserted.append(batch)
        snap()
    eng.close()
    return states


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fuzz") / "dep")
    states = _deployment(d, seed=3)
    path = os.path.join(d, "wal-0.log")
    with open(path, "rb") as f:
        pristine = f.read()
    return d, path, pristine, states


@settings(max_examples=25, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_corrupted_wal_recovers_exact_prefix_state(deployment, data):
    d, path, pristine, states = deployment
    assert len(states) >= 8
    if data.draw(st.booleans(), label="truncate"):
        blob = pristine[:data.draw(st.integers(0, len(pristine)),
                                   label="cut")]
    else:
        off = data.draw(st.integers(_MAGIC_LEN, len(pristine) - 1),
                        label="offset")
        bit = data.draw(st.integers(0, 7), label="bit")
        blob = bytearray(pristine)
        blob[off] ^= 1 << bit
        blob = bytes(blob)
    try:
        with open(path, "wb") as f:
            f.write(blob)
        rec = ServingEngine.open(d, device="cpu", backend="cuda")
        try:
            triple = (rec.version, rec.epoch, rec.fingerprint())
            assert triple in states, f"{triple} is not a prefix state"
            np.testing.assert_allclose(rec.Z.numpy(), states[triple],
                                       atol=1e-5)
            rec.apply_edge_delta(np.array([0], np.int32),
                                 np.array([1], np.int32),
                                 np.ones(1, np.float32))
        finally:
            rec.close()
    finally:
        with open(path, "wb") as f:
            f.write(pristine)
