"""The port's contract audit (``repro_torch.analysis``) on the CPU:

* the registry holds the reference's eleven names, and each entry's result
  at the audit shapes is the reference entry point's on the same seeded
  inputs (bitwise, or ids moving only between distances tied within rtol
  1e-5, as the port's own tests state for each path);
* the audit passes against the committed golden ``contracts_torch.json``;
* injected faults trip the gate: a ``.double()`` on a device path fails the
  float64 policy, a ``.item()`` in ``bucket_search_launch`` fails its
  ``sync_free`` policy (and ``no_host_sync``), an extra ``ops.lb_keogh``
  call shows in the diff, a kernel that bypasses ``ops`` is an error;
* the diff is exact on counts, and skips the ``aten_ops`` histogram, with a
  stated reason, under another torch version."""
import json

import numpy as np
import pytest
import torch

from _torch_port import assert_ties_only, torch_threads  # noqa: F401
from repro_torch.analysis import audit, contracts, guards, registry
from repro_torch.core import search_device as sd

CPU = "cpu"
S = registry.AUDIT_SHAPES
K, NBR = registry.AUDIT_K, registry.AUDIT_NBR


@pytest.fixture(scope="module")
def audited():
    """``{name: (result, contract)}`` of every entry on the CPU."""
    out = {}
    for e in registry.entries():
        res, census = contracts.run_entry(e, CPU)
        out[e.name] = (res, census.contract())
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's index (same data and parameters) and its device
    layouts at the audit chunk."""
    from repro.core.build import DumpyParams
    from repro.core.device_index import DeviceIndex
    from repro.core.index import DumpyIndex
    from repro.core.sax import SaxParams
    from repro.core.split import SplitParams
    st = registry.audit_state(CPU)
    ri = DumpyIndex.build(st.db, DumpyParams(
        sax=SaxParams(w=S["w"], b=S["b"]), split=SplitParams(th=S["th"])))
    devs = {n: DeviceIndex.from_index(ri, chunk=S["chunk"], n_shards=n)
            for n in (1, 4)}
    return ri, devs


def test_registry_names_are_the_reference_names():
    from repro.analysis import registry as r_registry
    assert registry.names() == r_registry.names()
    assert len(registry.names()) == 11


def test_audit_passes_against_the_committed_golden(audited, capsys):
    results = {n: c for n, (_, c) in audited.items()}
    assert audit.run_audit(device=CPU, results=results) == 0
    out = capsys.readouterr().out
    assert "PASS on cpu: 11 entries, 0 policy violation(s)" in out
    golden = json.loads(audit.GOLDEN_PATH.read_text())
    assert golden["_meta"]["device"] == CPU
    assert set(golden["programs"]) == set(registry.names())


def test_flags_hold_on_the_cpu_census(audited):
    """The declared flags are what the code does: the sync-free entries
    wait for nothing, no entry makes a float64 or moves between devices,
    and the exact ED census counts the search's own host syncs plus the
    query upload and the two result downloads."""
    for e in registry.entries():
        c = audited[e.name][1]
        assert contracts.policy_violations(e, c) == [], e.name
        if e.sync_free:
            assert c["host_syncs"] == {}, e.name
    ed = audited["search_exact_ed"][1]["host_syncs"]
    ids, d, vis, st = sd.exact_search_device_batch(
        registry.audit_state(CPU).index, registry.audit_state(CPU).qs, K,
        chunk=S["chunk"], device=CPU, return_stats=True)
    assert sum(ed.values()) == st["host_syncs"] + 1 + 2
    assert ed["Tensor.to"] == 1 and ed["Tensor.__bool__"] >= 2


# ---------------------------------------------------------------------------
# each entry's result against the reference entry point
# ---------------------------------------------------------------------------

EXACT = {"search_exact_ed": {},
         "search_exact_dtw": dict(metric="dtw", order="shared"),
         "search_exact_dtw_lane": dict(metric="dtw", order="cluster"),
         "search_exact_ed_degraded": dict(
             shard_health=registry.DEGRADED_HEALTH)}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_entries_bitwise_the_reference(name, audited, ref):
    from repro.core.search_device import exact_search_device_batch as r_exact
    ri, devs = ref
    kw = EXACT[name]
    dev = devs[4 if "shard_health" in kw else 1]
    want = r_exact(ri, registry.audit_state(CPU).qs, K, dev=dev, **kw)
    got = audited[name][0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_extended_entry_bitwise_the_reference(audited, ref):
    from repro.core.search_device import extended_search_device_batch as r_ext
    ri, devs = ref
    want = r_ext(ri, registry.audit_state(CPU).qs, K, nbr=NBR, dev=devs[1])
    for a, b in zip(audited["search_extended"][0], want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_approx_entry_matches_the_reference(audited, ref):
    from repro.core.search_device import approximate_search_device_batch
    ri, devs = ref
    r_ids, r_d, r_leaves = (np.asarray(a) for a in
                            approximate_search_device_batch(
                                ri, registry.audit_state(CPU).qs, K,
                                nbr=NBR, dev=devs[1]))
    ids, d, leaves = audited["search_approx"][0]
    np.testing.assert_array_equal(leaves, r_leaves)
    assert_ties_only(ids, d, r_ids, r_d)


def test_oneshot_entry_matches_the_reference(audited, ref):
    import jax.numpy as jnp
    from repro.core.distributed import search_step as r_step
    ri, devs = ref
    st = registry.audit_state(CPU)
    r_ids, r_d, r_lbs = (np.asarray(a) for a in r_step(
        jnp.asarray(st.qs), jnp.asarray(ri.db_ordered),
        jnp.asarray(np.asarray(devs[1].leaf_lo_g)),
        jnp.asarray(np.asarray(devs[1].leaf_hi_g)), K))
    ids, d, lbs = (t.numpy() for t in audited["search_oneshot"][0])
    np.testing.assert_allclose(lbs, r_lbs, rtol=1e-6)
    assert_ties_only(ids, d, r_ids, r_d)


def test_build_entries_bitwise_the_reference(audited):
    import jax.numpy as jnp
    from repro.core.build_device import _lexsort_words as r_lexsort
    from repro.core.distributed import build_step as r_build_step
    st = registry.audit_state(CPU)
    paa, sax, hist = audited["build_step"][0]
    r_paa, r_sax, r_hist = (np.asarray(a) for a in r_build_step(
        jnp.asarray(st.db), S["w"], S["b"]))
    np.testing.assert_allclose(paa.numpy(), r_paa, atol=1e-5)
    np.testing.assert_array_equal(sax.numpy(), r_sax)
    np.testing.assert_array_equal(hist.numpy(), r_hist)
    got = audited["build_bottomup"][0]
    want = r_lexsort(jnp.asarray(st.sax_dev.numpy()), S["w"], S["b"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_serving_entries_match_the_reference(audited, ref):
    from repro.core.search_device import bucket_search_device_batch as r_bucket
    from repro.core.search_device import extended_search_device_batch as r_ext
    from repro.serving.knn_softmax import KnnSoftmaxHead as RHead
    ri, devs = ref
    st = registry.audit_state(CPU)
    # the bucket launch, harvested, against the reference's bucket
    ks = np.asarray(registry.BUCKET_KS)
    ids, d, leaves = sd.bucket_search_finish(
        audited["serving_bucket"][0], ks, registry.BUCKET_NBRS, k_max=K)
    mets = ["dtw" if m else "ed" for m in registry.BUCKET_DTW]
    r_ids, r_d, r_leaves = (np.asarray(a) for a in r_bucket(
        ri, st.qs, ks, np.maximum(registry.BUCKET_NBRS, 1), mets, k_max=K,
        nbr_max=NBR, dev=devs[1]))
    np.testing.assert_array_equal(leaves, r_leaves)
    assert_ties_only(ids, d, r_ids, r_d)
    # the kNN-softmax head: its candidates are the port's extended search
    # without re-rank, which is the reference's up to ties
    head, s = st.head, registry.SERVING_SHAPES
    r_head = RHead(head.lm_head, w=s["w"], th=registry.SERVING_TH,
                   r_candidates=s["r_candidates"], nbr_nodes=s["nbr"])
    qp = head._encode_queries(st.hidden)
    p_ids, p_d, p_leaves = sd.extended_search_device_batch(
        head.index, qp, head.r, nbr=head.nbr, rerank=False, device=CPU)
    np.testing.assert_array_equal(audited["serving_head"][0], p_ids)
    r_ids, r_d, r_leaves = (np.asarray(a) for a in r_ext(
        r_head.index, qp, r_head.r, nbr=r_head.nbr, rerank=False))
    np.testing.assert_array_equal(p_leaves, r_leaves)
    assert_ties_only(p_ids, p_d, r_ids, r_d)


# ---------------------------------------------------------------------------
# injected faults trip the gate
# ---------------------------------------------------------------------------

def _entry(name):
    return registry.entries([name])[0]


def test_float64_on_a_device_path_trips_the_policy(monkeypatch):
    """The classic leak: a wide intermediate somebody narrows back down —
    the float64 op stays on the device path."""
    orig = sd._prep_batch

    def upcast(metric, qs_dev, w, b):
        return orig(metric, (qs_dev.double() * 1.0000001).float(), w, b)

    monkeypatch.setattr(sd, "_prep_batch", upcast)
    e = _entry("search_approx")
    _, census = contracts.run_entry(e, CPU)
    c = census.contract()
    assert "float64" in c["dtypes"]
    v = contracts.policy_violations(e, c)
    assert v and "float64" in v[0]


def test_item_in_the_bucket_launch_trips_sync_free(monkeypatch):
    orig = sd._bucket_knn_sharded

    def with_item(dev, *a, **kw):
        out = orig(dev, *a, **kw)
        out[0][0, 0].item()               # a debugging read left behind
        return out

    monkeypatch.setattr(sd, "_bucket_knn_sharded", with_item)
    e = _entry("serving_bucket")
    _, census = contracts.run_entry(e, CPU)
    c = census.contract()
    assert c["host_syncs"] == {"Tensor.item": 1}
    v = contracts.policy_violations(e, c)
    assert v and "sync-free" in v[0]
    st = registry.audit_state(CPU)
    with pytest.raises(guards.HostSyncError, match="Tensor.item"):
        with guards.no_host_sync(CPU):
            e.setup(st)()


def test_clean_bucket_launch_passes_no_host_sync():
    st = registry.audit_state(CPU)
    with guards.no_host_sync(CPU):
        d2, ids, leaves = _entry("serving_bucket").setup(st)()
    assert d2.shape == (registry.AUDIT_Q_BATCH, K)


def test_extra_kernel_call_shows_in_the_diff(monkeypatch):
    from repro_torch.kernels import ops
    orig = sd._dist2_gather

    def twice(metric, qs, prep, cand, valid, cutoff2):
        if metric.is_dtw:
            ops.lb_keogh(cand, prep[3], prep[2])    # the stage, twice
        return orig(metric, qs, prep, cand, valid, cutoff2)

    monkeypatch.setattr(sd, "_dist2_gather", twice)
    golden = json.loads(audit.GOLDEN_PATH.read_text())["programs"]
    _, census = contracts.run_entry(_entry("serving_bucket"), CPU)
    drift = contracts.diff_contract("serving_bucket",
                                    golden["serving_bucket"],
                                    census.contract(),
                                    keys=audit.CARD_KEYS)
    assert "serving_bucket: kernel_calls.histogram.lb_keogh: 4 -> 8" in drift
    assert any("kernel_calls.sequence" in d for d in drift)


def test_a_kernel_outside_ops_is_an_error():
    from repro_torch.kernels import ref
    x = torch.ones(2, 8)
    with pytest.raises(contracts.CensusError, match="outside ops.sax_encode"):
        with contracts.Census(CPU):
            ref.sax_encode_ref(x, 4, 4)
    with contracts.Census(CPU) as c:
        from repro_torch.kernels import ops
        ops.lb_isax(torch.zeros(2, 4), torch.zeros(3, 4), torch.ones(3, 4),
                    8)
    assert dict(c.kernel_calls) == {"lb_paa_interval": 1}


def test_build_step_is_sync_free(audited):
    """The repair of ``build_step``'s histogram: ``torch.bincount`` reads
    its input's min and max on the host (on a card, two syncs); the
    scatter-add gives the same counts without a read."""
    from repro_torch.core.distributed import build_step
    from repro_torch.core.sax import next_bit_codes_t
    db = torch.from_numpy(registry.audit_state(CPU).db[:1000])
    with guards.no_host_sync(CPU):
        _, sax, hist = build_step(db, S["w"], S["b"])
    codes = next_bit_codes_t(sax, torch.zeros(S["w"], dtype=torch.int32),
                             S["w"], S["b"])
    assert torch.equal(hist, torch.bincount(codes, minlength=1 << S["w"]))
    with contracts.Census(CPU) as c:
        torch.bincount(codes.clone(), minlength=4)
    assert c.host_syncs == {"torch.bincount": 1}


# ---------------------------------------------------------------------------
# the diff and the policies
# ---------------------------------------------------------------------------

def _contract(**over):
    base = {"kernel_calls": {"histogram": {"sax_encode": 1,
                                           "pairwise_l2": 32},
                             "sequence": "0123456789abcdef"},
            "aten_ops": {"aten.add.Tensor": 3, "aten.topk.default": 32},
            "eager_launches": 35,
            "dtypes": ["bool", "float32", "int32"],
            "host_syncs": {"Tensor.cpu": 3, "Tensor.__bool__": 2},
            "device_moves": 0, "peak_bytes": 1000}
    base.update(over)
    return base


def test_diff_is_exact_on_counts():
    g = _contract()
    c = _contract(host_syncs={"Tensor.cpu": 3, "Tensor.__bool__": 3},
                  peak_bytes=5000)
    assert contracts.diff_contract("p", g, c) == [
        "p: host_syncs.Tensor.__bool__: 2 -> 3"]
    c2 = _contract(kernel_calls={"histogram": {"sax_encode": 1,
                                               "pairwise_l2": 33},
                                 "sequence": "0123456789abcdef"})
    assert contracts.diff_contract("p", g, c2) == [
        "p: kernel_calls.histogram.pairwise_l2: 32 -> 33"]
    c3 = _contract(dtypes=["bool", "float32", "float64", "int32"])
    assert contracts.diff_contract("p", g, c3) == [
        "p: dtypes: ['bool', 'float32', 'int32'] -> "
        "['bool', 'float32', 'float64', 'int32']"]


def test_aten_ops_skipped_under_another_torch_version(audited, capsys):
    g = _contract()
    c = _contract(aten_ops={"aten.add.Tensor": 4}, eager_launches=4)
    assert contracts.diff_contract("p", g, c, compare_aten=False) == []
    assert len(contracts.diff_contract("p", g, c)) == 3
    reason = contracts.aten_skip_reason("0.0.0+elsewhere")
    assert "0.0.0+elsewhere" in reason and torch.__version__ in reason
    assert contracts.aten_skip_reason(torch.__version__) is None
    # the audit prints the skip and still compares every other field
    golden = json.loads(audit.GOLDEN_PATH.read_text())
    golden["_meta"]["torch"] = "0.0.0+elsewhere"
    name = "build_step"
    golden["programs"][name]["aten_ops"] = {"aten.nothing.default": 1}
    res = {name: audited[name][1]}
    problems, drift, notes = audit.check(res, CPU, golden, names=[name])
    assert problems == [] and drift == [] and notes == [reason]
    golden["programs"][name]["host_syncs"] = {"Tensor.cpu": 1}
    _, drift, _ = audit.check(res, CPU, golden, names=[name])
    assert "build_step: host_syncs.Tensor.cpu: 1 -> None" in drift


def test_policies_are_never_blessed(tmp_path):
    e = registry.Entry("p", "test", setup=None, sync_free=True,
                       sharded=False)
    bad = _contract(dtypes=["float64"], device_moves=2)
    v = contracts.policy_violations(e, bad)
    assert len(v) == 3
    assert "float64" in v[0] and "sync-free" in v[1] and "shard-local" in v[2]
    ok = _contract(host_syncs={})
    assert contracts.policy_violations(e, ok) == []
    # --update refuses a card extraction and still fails on a violation
    assert audit.run_audit(update=True, device="cuda",
                           golden_path=tmp_path / "g.json") == 1


def test_scalar_through_a_tensor_index_is_a_sync():
    """On a card ``t[idx] = 0.0`` stages the scalar in host memory and
    copies it up; a slice assignment or a tensor value does not.  The
    approximate search's routed-leaf mask now scatters the scalar instead
    (its census: the query upload and the three result downloads only)."""
    t = torch.zeros(4, 5)
    idx = torch.tensor([0, 2])
    with contracts.Census(CPU) as c:
        u = t * 1                                   # a device tensor
        u[1:3] = 0.0
        u[idx] = torch.ones(5)
        u.scatter(1, idx[:, None].expand(2, 1), 0.0)
    assert c.host_syncs == {}
    with contracts.Census(CPU) as c:
        u = t * 1
        u[idx] = 0.0
    assert c.host_syncs == {"Tensor.__setitem__": 1}
    e = _entry("search_approx")
    _, census = contracts.run_entry(e, CPU)
    assert census.contract()["host_syncs"] == {"Tensor.cpu": 3,
                                               "Tensor.to": 1}


def test_census_restores_what_it_swaps():
    """Twin of ``test_compile_counter_counts_and_restores``: the census
    counts one kernel call and gives back ``ops``, the kernel modules, the
    twins and ``torch.from_numpy`` on exit, an exception included."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sax_encode as se_mod
    before = (ops.sax_encode, se_mod.sax_encode, ref.sax_encode_ref,
              torch.from_numpy)
    with pytest.raises(ZeroDivisionError):
        with contracts.Census(CPU) as c:
            ops.sax_encode(torch.ones(3, 8), 4, 4)
            1 / 0
    assert dict(c.kernel_calls) == {"sax_encode": 1}
    assert (ops.sax_encode, se_mod.sax_encode, ref.sax_encode_ref,
            torch.from_numpy) == before
