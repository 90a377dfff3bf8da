"""The port's crash-safe persistence against the reference: the failpoint
registry, the write-ahead log, generation save/load with a crash at every
save site, corruption fallbacks, and stores and logs that cross between
the two packages (the on-disk format is shared).

Faults are injected in this process only as ``InjectedCrash`` through
``fp.armed``; the one real process death (the ``exit`` action) is armed in
a child process's own environment.  Every file lives under ``tmp_path``
or a ``tempfile`` directory."""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
from _propcheck import given, settings, st

from _torch_port import params_pair, torch_threads  # noqa: F401
from repro.core.index import DumpyIndex as RIndex
from repro.core.index import _tree_to_json as r_tree_to_json
from repro.robustness import failpoints as rfp
from repro.robustness.wal import WriteAheadLog as RWal
from repro_torch.core.build import DumpyParams
from repro_torch.core.index import (DumpyIndex, IndexCorruptionError,
                                    _params_to_json, _tree_to_json)
from repro_torch.core.sax import SaxParams
from repro_torch.core.split import SplitParams
from repro_torch.data.series import random_walks
from repro_torch.robustness import failpoints as fp
from repro_torch.robustness import smoke
from repro_torch.robustness.wal import WriteAheadLog

ROOT = Path(__file__).resolve().parents[1]
FUZZY = DumpyParams(sax=SaxParams(w=8, b=8), split=SplitParams(th=64),
                    fuzzy_f=0.15)
FINE = DumpyParams(sax=SaxParams(w=8, b=8), split=SplitParams(th=64))
SAVE_SITES = ("index.save.begin", "index.save.arrays", "index.save.meta",
              "index.save.manifest", "index.save.rename",
              "index.save.commit", "index.save.post_commit",
              "index.save.prune")
ROUTING_FIELDS = ("node_csl", "node_shift", "node_lam", "edge_parent",
                  "edge_sid", "edge_leaf", "edge_child", "edge_lo", "edge_hi",
                  "edge_nl", "edge_begin", "edge_end", "node_begin",
                  "node_end", "leaf_parent", "grp_off", "grp_begin",
                  "grp_end", "grp_lo", "grp_hi")


@pytest.fixture(autouse=True)
def _clean_registries():
    fp.REGISTRY.disarm()
    rfp.REGISTRY.disarm()
    yield
    fp.REGISTRY.disarm()
    rfp.REGISTRY.disarm()


def _assert_same_state(a, b, routing: bool = True) -> None:
    """Every persisted array, the leaf layout, the stats and the tree of two
    indexes (of either package), and with ``routing`` the flat routing
    tables.  The tables number internal nodes in the order of each node's
    child dict, which a load rebuilds sorted by sid: an index that took
    inserts in memory and its reload agree on the tree, not on the
    numbering."""
    for f in ("db", "paa", "sax", "alive"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("leaf_sym", "leaf_card", "leaf_lo", "leaf_hi", "leaf_offsets",
              "order"):
        np.testing.assert_array_equal(getattr(a.flat, f), getattr(b.flat, f),
                                      err_msg=f)
    if routing:
        ra, rb = a.routing_flat, b.routing_flat
        for f in ROUTING_FIELDS:
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f),
                                          err_msg=f)
        assert ra.depth == rb.depth
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert _tree_to_json(a.root) == _tree_to_json(b.root)


# -- failpoint registry (twins of the reference's layer-1 tests) ------------

def test_failpoint_sites_match_reference():
    assert fp.SITES == rfp.SITES
    assert fp.ENV_VAR == rfp.ENV_VAR


def test_parse_action_specs():
    act = fp.parse_action("flaky:2")
    assert act.kind == "flaky" and act.times == 2
    assert fp.parse_action("flaky").times == 1
    assert fp.parse_action("delay:0.05").delay == 0.05
    act = fp.parse_action("raise:p=0.5:seed=7")
    assert act.p == 0.5 and act.seed == 7
    assert fp.parse_action("exit:3").code == 3
    assert fp.parse_action(fp.Action("crash")).kind == "crash"
    with pytest.raises(ValueError, match="unknown failpoint action"):
        fp.parse_action("explode")
    with pytest.raises(ValueError, match="unknown failpoint option"):
        fp.parse_action("raise:q=1")


def test_armed_scoping_and_nesting():
    fp.failpoint("a")                       # disarmed: no-op
    with fp.armed({"a": "raise"}):
        with pytest.raises(fp.FailpointError):
            fp.failpoint("a")
        with fp.armed(b="raise"):           # keyword form, __ → .
            assert fp.is_armed("b")
            with pytest.raises(fp.FailpointError):
                fp.failpoint("b")
        assert not fp.is_armed("b")
        assert fp.is_armed("a")             # inner exit left outer armed
    assert not fp.is_armed("a")
    fp.failpoint("a")


def test_flaky_heals_and_counts():
    with fp.armed({"s": "flaky:2"}):
        for _ in range(2):
            with pytest.raises(fp.FailpointError):
                fp.failpoint("s")
        fp.failpoint("s")                   # healed
        fp.failpoint("s")
        assert fp.REGISTRY.fires("s") == 2
        assert fp.REGISTRY.hits("s") == 4


def _firing_pattern(mod) -> list[int]:
    out = []
    with mod.armed({"s": "raise:p=0.4:seed=11"}):
        for _ in range(24):
            try:
                mod.failpoint("s")
                out.append(0)
            except mod.FailpointError:
                out.append(1)
    return out


def test_probabilistic_firing_is_seeded_as_in_the_reference():
    first = _firing_pattern(fp)
    assert 0 < sum(first) < 24              # actually probabilistic
    assert _firing_pattern(fp) == first     # and exactly reproducible
    assert _firing_pattern(rfp) == first    # the reference's sequence


def test_with_retries_recovers_and_exhausts():
    calls = []
    with fp.armed({"s": "flaky:2"}):
        def op():
            calls.append(1)
            fp.failpoint("s")
            return "ok"
        assert fp.with_retries(op, backoff=0.0001, site="s") == "ok"
    assert len(calls) == 3                  # 2 failures + 1 success

    with fp.armed({"s": "flaky:5"}):
        with pytest.raises(fp.RetriesExhausted) as ei:
            fp.with_retries(lambda: fp.failpoint("s"), retries=2,
                            backoff=0.0001, site="s")
    assert isinstance(ei.value.__cause__, fp.FailpointError)


def test_injected_crash_is_not_an_exception():
    assert not issubclass(fp.InjectedCrash, Exception)
    with fp.armed({"s": "crash"}):
        with pytest.raises(fp.InjectedCrash):
            # with_retries must not absorb a crash as a transient fault
            fp.with_retries(lambda: fp.failpoint("s"), site="s")


def test_arm_from_env_spec(monkeypatch):
    reg = fp.FailpointRegistry()
    assert reg.arm_from_env("a=crash; b=flaky:2,c") == 3
    assert reg.is_armed("a") and reg.is_armed("b")
    assert reg._sites["c"].action.kind == "raise"   # bare site → raise
    assert reg._sites["b"].action.times == 2
    monkeypatch.setenv(fp.ENV_VAR, "x=delay:0.001")
    reg = fp.FailpointRegistry()
    assert reg.arm_from_env() == 1 and reg._sites["x"].action.delay == 0.001
    assert not fp.REGISTRY._sites            # the process registry untouched


# -- write-ahead log -------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(st.integers(1, 5), st.integers(1, 48))
def test_wal_roundtrip_property(n_batches, rows):
    rng = np.random.default_rng(n_batches * 100 + rows)
    batches = [rng.normal(size=(rows, 16)).astype(np.float32)
               for _ in range(n_batches)]
    with tempfile.TemporaryDirectory() as tmp:
        wal = WriteAheadLog(os.path.join(tmp, "w.log"))
        for b in batches:
            wal.append(b)
        got = wal.replay()
    assert len(got) == n_batches
    for want, have in zip(batches, got):
        assert have.dtype == np.float32
        np.testing.assert_array_equal(want, have)


def test_wal_torn_tail_repaired(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.log"))
    b = np.ones((3, 8), np.float32)
    wal.append(b)
    wal.append(2 * b)
    with open(wal.path, "ab") as fh:
        fh.write(b"DWAL\x00garbage-torn-tail")
    torn_size = os.path.getsize(wal.path)
    got = wal.replay()
    assert len(got) == 2
    assert os.path.getsize(wal.path) < torn_size    # repaired
    wal.append(3 * b)                               # clean tail: appendable
    assert len(wal.replay()) == 3


def test_wal_digest_corruption_drops_record(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.log"))
    wal.append(np.ones((2, 8), np.float32))
    first_end = os.path.getsize(wal.path)
    wal.append(np.full((2, 8), 2, np.float32))
    with open(wal.path, "r+b") as fh:               # flip a payload byte of
        fh.seek(first_end + 60)                     # the second record
        byte = fh.read(1)
        fh.seek(first_end + 60)
        fh.write(bytes([byte[0] ^ 0xFF]))
    got = wal.replay()
    assert len(got) == 1
    np.testing.assert_array_equal(got[0], np.ones((2, 8), np.float32))


def test_wal_append_retries_transient_faults(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.log"))
    with fp.armed({"wal.append": "flaky:2"}):
        wal.append(np.ones((2, 8), np.float32))
        assert fp.REGISTRY.fires("wal.append") == 2
    assert len(wal.replay()) == 1


def test_wal_tear_crash_leaves_recoverable_log(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.log"))
    wal.append(np.ones((2, 8), np.float32))
    with fp.armed({"wal.append.tear": "crash"}):
        with pytest.raises(fp.InjectedCrash):
            wal.append(np.full((2, 8), 2, np.float32))
    got = wal.replay()                              # torn tail dropped
    assert len(got) == 1
    wal.append(np.full((2, 8), 3, np.float32))
    assert len(wal.replay()) == 2


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_wal_frames_cross_packages(tmp_path, writer):
    """The same batches give the same bytes in either package, and a log
    written by one replays (torn tail and all) in the other."""
    rng = np.random.default_rng(3)
    batches = [rng.normal(size=(m, 24)).astype(np.float32) for m in (1, 5, 2)]
    mine, theirs = (RWal, WriteAheadLog) if writer == "repro" \
        else (WriteAheadLog, RWal)
    a, b = (mine(str(tmp_path / "a.log")), theirs(str(tmp_path / "b.log")))
    for x in batches:
        a.append(x)
        b.append(x)
    assert Path(a.path).read_bytes() == Path(b.path).read_bytes()
    with open(a.path, "ab") as fh:
        fh.write(b"DWAL\x01torn")
    got = theirs(a.path).replay()
    assert len(got) == len(batches)
    for want, have in zip(batches, got):
        np.testing.assert_array_equal(want, have)
    assert Path(a.path).read_bytes() == Path(b.path).read_bytes()


# -- crash-safe persistence -----------------------------------------------------

def _build_fuzzy_with_tombstones():
    db = random_walks(1500, 64, seed=5)
    idx = DumpyIndex.build(db, FUZZY)
    assert idx.stats.n_duplicates > 0               # fuzzy replicas present
    for sid in (3, 111, 270, 1499):
        idx.delete(sid)
    return idx


@pytest.mark.parametrize("site", SAVE_SITES)
def test_crash_at_every_save_failpoint(tmp_path, site):
    """A save crashed at any site must leave the store loadable, and the
    load must reproduce the complete pre-crash state — either the previous
    generation plus its WAL, or the freshly committed generation."""
    idx = _build_fuzzy_with_tombstones()
    path = str(tmp_path / "idx")
    idx.save(path)
    idx.insert_many(random_walks(9, 64, seed=6))    # → WAL of gen-000001
    with fp.armed({site: "crash"}):
        with pytest.raises(fp.InjectedCrash):
            idx.save(path)
    re = DumpyIndex.load(path)
    _assert_same_state(re, idx, routing=False)
    # post-crash saves are idempotent: stale tmp droppings are cleared
    idx.save(path)
    assert not [n for n in os.listdir(path) if n.endswith(".tmp")]
    re2 = DumpyIndex.load(path)
    _assert_same_state(re2, idx, routing=False)
    _assert_same_state(re2, re)


def test_crash_in_wal_append_keeps_index_consistent(tmp_path):
    db = random_walks(400, 64, seed=7)
    idx = DumpyIndex.build(db, FINE)
    path = str(tmp_path / "idx")
    idx.save(path)
    batch = random_walks(5, 64, seed=8)
    for site in ("wal.append", "wal.append.tear"):
        with fp.armed({site: "crash"}):
            with pytest.raises(fp.InjectedCrash):
                idx.insert_many(batch)
        assert idx.db.shape[0] == 400        # durability-first: no mutation
        re = DumpyIndex.load(path)           # torn tail (if any) dropped
        np.testing.assert_array_equal(re.db, db)
    idx.insert_many(batch)                   # log is still appendable
    re = DumpyIndex.load(path)
    np.testing.assert_array_equal(re.db, idx.db)


def _flip_byte(path: str, off: int = 100) -> None:
    with open(path, "r+b") as fh:
        fh.seek(off)
        byte = fh.read(1)
        fh.seek(off)
        fh.write(bytes([byte[0] ^ 0xFF]))


def test_corrupt_generation_falls_back(tmp_path):
    idx = DumpyIndex.build(random_walks(400, 64, seed=9), FINE)
    path = str(tmp_path / "idx")
    idx.save(path)                                  # gen-000001
    idx.insert_many(random_walks(6, 64, seed=10))   # → wal-000001
    idx.save(path)                                  # gen-000002
    _flip_byte(os.path.join(path, "gen-000002", "arrays.npz"))
    re = DumpyIndex.load(path)                      # gen-000001 + its WAL
    np.testing.assert_array_equal(re.db, idx.db)
    np.testing.assert_array_equal(re.alive, idx.alive)


def test_prune_keeps_two_generations(tmp_path):
    idx = DumpyIndex.build(random_walks(300, 64, seed=17), FINE)
    path = str(tmp_path / "idx")
    for i in range(3):
        idx.save(path)
        idx.insert_many(random_walks(2, 64, seed=20 + i))   # → wal-00000i
    assert sorted(os.listdir(path)) == [
        "CURRENT", "gen-000002", "gen-000003", "wal-000002.log",
        "wal-000003.log"]
    assert Path(path, "CURRENT").read_text() == "gen-000003\n"
    np.testing.assert_array_equal(DumpyIndex.load(path).db, idx.db)


def test_all_generations_corrupt_raises(tmp_path):
    idx = DumpyIndex.build(random_walks(300, 64, seed=11), FINE)
    path = str(tmp_path / "idx")
    idx.save(path)
    idx.save(path)
    for gen in ("gen-000001", "gen-000002"):
        _flip_byte(os.path.join(path, gen, "arrays.npz"))
    with pytest.raises(IndexCorruptionError, match="no intact generation"):
        DumpyIndex.load(path)


def test_missing_store_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no index at"):
        DumpyIndex.load(str(tmp_path / "nothing"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no index generations"):
        DumpyIndex.load(str(tmp_path / "empty"))


def _edit_manifest(path: str, edit) -> None:
    mpath = os.path.join(path, "gen-000001", "manifest.json")
    with open(mpath) as fh:
        manifest = json.load(fh)
    edit(manifest)
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)


def test_manifest_shape_mismatch_is_precise(tmp_path):
    idx = DumpyIndex.build(random_walks(300, 64, seed=12), FINE)
    path = str(tmp_path / "idx")
    idx.save(path)
    _edit_manifest(path, lambda m: m["arrays"]["db"].update(shape=[300, 63]))
    with pytest.raises(IndexCorruptionError, match="manifest says"):
        DumpyIndex.load(path)


def test_unknown_format_version_rejected(tmp_path):
    idx = DumpyIndex.build(random_walks(300, 64, seed=13), FINE)
    path = str(tmp_path / "idx")
    idx.save(path)
    _edit_manifest(path, lambda m: m.update(format_version=99))
    with pytest.raises(IndexCorruptionError, match="format_version"):
        DumpyIndex.load(path)


def test_legacy_flat_layout_loads(tmp_path):
    """Pre-generation stores (arrays.npz + meta.json directly under the
    path, no manifest) must keep loading."""
    idx = DumpyIndex.build(random_walks(300, 64, seed=14), FINE)
    path = str(tmp_path / "idx")
    os.makedirs(path)
    np.savez(os.path.join(path, "arrays.npz"),
             db=idx.db, paa=idx.paa, sax=idx.sax, alive=idx.alive,
             leaf_sym=idx.flat.leaf_sym, leaf_card=idx.flat.leaf_card,
             leaf_offsets=idx.flat.leaf_offsets, order=idx.flat.order)
    meta = {"params": _params_to_json(idx.params),
            "stats": dataclasses.asdict(idx.stats),
            "tree": _tree_to_json(idx.root)}
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    re = DumpyIndex.load(path)
    _assert_same_state(re, idx, routing=False)
    assert re._wal.path.endswith("wal-legacy.log")
    # the reference reads the same legacy store to the same state
    _assert_same_state(RIndex.load(path), re)


def test_load_restores_clean_state_and_wal(tmp_path):
    idx = DumpyIndex.build(random_walks(300, 64, seed=15), FINE)
    path = str(tmp_path / "idx")
    idx.save(path)
    re = DumpyIndex.load(path)
    assert re._dirty is False
    assert not re._device_cache and re._n_device_builds == 0
    assert re._db_ordered_dev is None
    assert re._wal is not None and re._store_path == path
    dev = re.device_index(chunk=64, device="cpu")
    assert re._n_device_builds == 1 and str(dev.device) == "cpu"
    re.insert_many(random_walks(3, 64, seed=16))    # WAL-logged
    assert re._dirty is True and not re._device_cache
    again = DumpyIndex.load(path)                   # replays that WAL
    np.testing.assert_array_equal(again.db, re.db)
    assert again._dirty is True                     # replay = pending inserts


def test_device_put_failpoint_retry():
    idx = DumpyIndex.build(random_walks(300, 64, seed=36), FINE)
    with fp.armed({"device.put": "flaky:2"}):
        dev = idx.device_index(device="cpu")
        assert fp.REGISTRY.fires("device.put") == 2
    assert int(dev.row_bounds[-1]) >= 300   # the upload still completed


_CHILD = """
import sys
import numpy as np
from repro_torch.core.index import DumpyIndex
idx = DumpyIndex.load(sys.argv[1])
idx.insert_many(np.load(sys.argv[2]))
idx.save(sys.argv[1])          # the armed commit site ends this process
print("not reached")
"""


def test_exit_failpoint_kills_a_child_and_the_store_recovers(tmp_path):
    """A real process death at the commit (the ``exit`` action, armed in
    the child's own environment only): the next load recovers the
    child's WAL-logged batch on top of the previous generation."""
    idx = DumpyIndex.build(random_walks(400, 64, seed=18), FINE)
    path = str(tmp_path / "idx")
    idx.save(path)
    batch = random_walks(6, 64, seed=19)
    np.save(tmp_path / "batch.npy", batch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               DUMPY_FAILPOINTS="index.save.commit=exit:66")
    out = subprocess.run([sys.executable, "-c", _CHILD, path,
                          str(tmp_path / "batch.npy")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 66, out.stderr
    assert "not reached" not in out.stdout
    assert not fp.REGISTRY._sites           # nothing armed in this process
    idx.insert_many(batch, log_wal=False)   # the state the child reached
    re = DumpyIndex.load(path)
    _assert_same_state(re, idx, routing=False)


# -- the store crosses between the packages -----------------------------------

def _pair_with_history(seed: int = 40):
    """The same fuzzy index in both packages, with tombstones and a
    resplitting insert batch."""
    db = random_walks(1200, 64, seed=seed)
    rp, pp = params_pair(th=64, fuzzy_f=0.15)
    ri, pi = RIndex.build(db, rp), DumpyIndex.build(db, pp)
    extra = db[17] + 1e-3 * random_walks(80, 64, seed=seed + 1)
    ri.insert_many(extra, log_wal=False)
    pi.insert_many(extra)
    for sid in (2, 500, 1201):
        ri.delete(sid)
        pi.delete(sid)
    return ri, pi


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_generation_crosses_packages(tmp_path, writer):
    """A store saved by one package loads in the other to the same state,
    and a WAL batch logged by one replays in the other."""
    ri, pi = _pair_with_history()
    _assert_same_state(pi, ri)
    src, dst_cls = (ri, DumpyIndex) if writer == "repro" else (pi, RIndex)
    path = str(tmp_path / "idx")
    src.save(path)
    src.insert_many(random_walks(5, 64, seed=43))   # → the writer's WAL
    got = dst_cls.load(path)
    same = (RIndex if writer == "repro" else DumpyIndex).load(path)
    _assert_same_state(got, same)
    np.testing.assert_array_equal(got.db, src.db)
    np.testing.assert_array_equal(got.alive, src.alive)
    # and back: the reader's own save loads in the writer's package
    got.save(path)
    back = type(src).load(path)
    _assert_same_state(back, got)


def test_same_index_saves_the_same_meta_and_manifest(tmp_path):
    ri, pi = _pair_with_history(seed=44)
    ri.save(str(tmp_path / "r"))
    pi.save(str(tmp_path / "p"))
    gen = "gen-000001"
    assert (tmp_path / "r" / gen / "meta.json").read_bytes() == \
        (tmp_path / "p" / gen / "meta.json").read_bytes()
    mr, mp = (json.loads((tmp_path / d / gen / "manifest.json").read_text())
              for d in ("r", "p"))
    mr["files"].pop("arrays.npz")            # the zip entries carry a time
    mp["files"].pop("arrays.npz")
    assert mr == mp
    assert (tmp_path / "r" / "CURRENT").read_bytes() == \
        (tmp_path / "p" / "CURRENT").read_bytes()
    with np.load(tmp_path / "r" / gen / "arrays.npz") as a, \
            np.load(tmp_path / "p" / gen / "arrays.npz") as b:
        assert a.files == b.files
        for f in a.files:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_tree_json_matches_reference():
    ri, pi = _pair_with_history(seed=45)
    assert _tree_to_json(pi.root) == r_tree_to_json(ri.root)


# -- the robustness smoke -------------------------------------------------------

def test_smoke_crash_on_commit_cpu(capsys):
    assert smoke.crash_on_commit_smoke(device="cpu")
    assert "FAIL" not in capsys.readouterr().out


def test_smoke_degraded_search_cpu(capsys):
    assert smoke.degraded_search_smoke(device="cpu")
    assert "FAIL" not in capsys.readouterr().out
