"""The dry run of Dumpy's exact searches (``core.distributed``'s
``lower_search_sharded`` / ``lower_search_dtw`` / ``lower_search_degraded``
and ``exact_counted``) and the loop scaling they stand on
(``distributed.op_cost.scaled``).

The exact loops are driven by host reads (the span schedule, the stop
tests), so the dry run runs one trip of each loop body on fake tensors and
counts it once a trip of a loop that runs to its end, as the reference's
``hlo_cost`` scales a ``while`` body by its trip count.  Everything here is
exact: the cells' kernel work against closed forms, each scaled count
against the same program with every trip run (FLOPs, bytes, kernel
entries, aten ops, dtypes and host syncs equal; peaks equal, or the lane
walk's a stated few bytes apart), the degraded cell against the healthy
one, and the count over a real layout against a census of the real search
on it.  Sizes are small: a (4, 2) mesh, 16 384 × 64, chunk 1024, 256
leaves, Q 8 (32 for ``cluster``, which groups from Q 16), k 5.

Against the reference, the same cells lowered on 8 host devices in a child
process (``tests/_torch_dryrun_children.py exact``) and read by its
``hlo_cost``: every loop whose trip count ``hlo_cost`` reads (DTW
``shared``'s sub-slab loop, the lane program's LB slabs) has the port's
trip count exactly.  It reads none for the span loop and the lane walks,
whose conditions hold no constant after XLA's passes: it counts one trip
of each (``unknown_loops``), where the port counts every trip.  So the ED
cell's FLOPs are held to W times the reference's within 18%: the
reference counts ``dot``s alone (2·Q·chunk·n a span), the port's
``pairwise_l2`` also counts its norms and epilogue (2(Q + chunk)·n +
4·Q·chunk a span, 15.7% here, 2.4% at the production sizes) and the prune
scan once (1.4% here).  The reference's DTW programs hold no ``dot``: zero
FLOPs, nothing to compare.  Collectives differ by design: GSPMD partitions
the reference's vmapped loops, so each trip all-gathers every shard's
``[Q, pool + k]`` merge candidates and all-reduces the stop flag, and it
merges the lists through a dozen small collectives, each at most one
shard's ``[Q, k]`` distances and ids; the port runs each shard's loop
alone and counts the merge as one all-gather of (S − 1)·Q·k·8 bytes.
"""
import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import distributed as D
from repro_torch.core import search_device as sd
from repro_torch.distributed import op_cost

N, LENGTH, W_SAX, CHUNK, LEAVES, Q, K = 1 << 14, 64, 16, 1024, 256, 8, 5
KW = dict(n_series=N, length=LENGTH, w=W_SAX, chunk=CHUNK, n_leaves=LEAVES,
          k=K, device="cpu")
MESH = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 2))
S = 4                              # shards: the mesh's data axis
TP = N // S                        # rows a shard
SPANS = TP // CHUNK
#: each cell: its lowering and its query batch
CELLS = {
    "ed": (lambda q: D.lower_search_sharded(MESH, q_batch=q, **KW), Q),
    "dtw shared": (lambda q: D.lower_search_dtw(MESH, q_batch=q, **KW), Q),
    "dtw perq": (lambda q: D.lower_search_dtw(MESH, order="perq",
                                              q_batch=q, **KW), Q),
    "dtw cluster": (lambda q: D.lower_search_dtw(MESH, order="cluster",
                                                 q_batch=q, **KW), 32),
    "ed degraded": (lambda q: D.lower_search_degraded(MESH, q_batch=q, **KW),
                    Q),
}


#: the reference's lowering of each cell: its kind, query batch and order
REF_CELLS = {"ed": ("sharded", Q, None), "dtw shared": ("dtw", Q, "shared"),
             "dtw perq": ("dtw", Q, "perq"),
             "dtw cluster": ("dtw", 32, "cluster"),
             "ed degraded": ("degraded", Q, None)}
CHILD = Path(__file__).resolve().parent / "_torch_dryrun_children.py"


def _cell(name: str):
    make, q = CELLS[name]
    return make(q).analyze()


@pytest.fixture(scope="module")
def reference() -> dict:
    """The reference's cells at this file's sizes, from the child."""
    spec = dict(mesh=MESH.shape, n_series=N, length=LENGTH, w=W_SAX,
                chunk=CHUNK, n_leaves=LEAVES, k=K, cells=REF_CELLS)
    root = CHILD.parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(CHILD), "exact",
                          json.dumps(spec)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _alone(name: str, *args, **kw) -> dict:
    """One call of kernel ``name`` counted alone: its ``kernels`` entry."""
    from repro_torch.kernels import ops
    return op_cost.analyze(lambda *a: getattr(ops, name)(*a, **kw),
                           *args).kernels[name]


def _fake(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype)


def _times(entry: dict, n: int) -> dict:
    return {key: n * v for key, v in entry.items()}


# ---------------------------------------------------------------------------
# op_cost.scaled
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trips", [1, 3, 7])
def test_scaled_loop_counts_like_the_unrolled_loop(trips):
    """A carried loop of a matmul, a reduction and a kernel: one trip
    scaled by ``trips`` counts what ``trips`` trips count, and its peak is
    the loop's (the carry has one shape every trip, and only the loop holds
    the first one)."""
    from repro_torch.kernels import ops

    def body(x, w, q):
        y = torch.tanh(x @ w)
        return y, ops.pairwise_l2(q, y).sum()

    def run(x, w, q, scale):
        x = x + 1.0           # the first carry, held by the loop alone
        if scale:
            return op_cost.scaled("body", trips, body, x, w, q)[0]
        for _ in range(trips):
            x = body(x, w, q)[0]
        return x

    with FakeTensorMode():
        x, w, q = _fake(64, 32), _fake(32, 32), _fake(4, 32)
    scaled = op_cost.analyze(run, x, w, q, True)
    unrolled = op_cost.analyze(run, x, w, q, False)
    for f in ("flops", "flops_by_dtype", "hbm_bytes", "hbm_bytes_hi",
              "kernels", "aten_ops", "dtypes", "n_ops", "peak_bytes"):
        assert getattr(scaled, f) == getattr(unrolled, f), f
    assert scaled.loops == {"body": trips} and unrolled.loops == {}
    assert scaled.kernels["pairwise_l2"]["calls"] == trips
    assert scaled.aten_ops["aten.mm.default"] == trips


def test_scaled_sums_the_trips_of_one_loop_name():
    """One loop run once a group (as ``cluster``'s walk is): its record is
    the trips of every run, and the work is each run's trips."""
    from repro_torch.kernels import ops

    def run(q, x):
        for trips in (2, 5):
            op_cost.scaled("walk", trips, ops.pairwise_l2, q, x)
        return q

    with FakeTensorMode():
        q, x = _fake(4, 16), _fake(32, 16)
    cost = op_cost.analyze(run, q, x)
    assert cost.loops == {"walk": 7}
    assert cost.kernels["pairwise_l2"] == _times(_alone("pairwise_l2", q, x),
                                                 7)


def test_scaled_runs_only_inside_analyze_and_needs_a_trip():
    with pytest.raises(RuntimeError, match="inside analyze only"):
        op_cost.scaled("body", 3, lambda: None)
    with FakeTensorMode():
        x = _fake(4, 4)
    with pytest.raises(ValueError, match="0 trips"):
        op_cost.analyze(lambda x: op_cost.scaled("body", 0, torch.neg, x), x)


# ---------------------------------------------------------------------------
# the cells' closed forms
# ---------------------------------------------------------------------------

def test_exact_ed_cell_is_its_closed_form():
    """The prune scan once over the shard's leaves (256 / 4 plus the pad
    leaf), ``pairwise_l2`` once a span at ``[Q, chunk, n]`` (the one-shot
    cell's formulas at X = chunk), the merge one all-gather."""
    cost = _cell("ed")
    Lp = LEAVES // S + 1
    X, n = CHUNK, LENGTH
    assert cost.loops == {"span": SPANS}
    assert cost.kernels == {
        "lb_paa_interval": {"calls": 1,
                            "flops": 7 * Q * Lp * W_SAX + Q * Lp,
                            "bytes": 4 * (2 * Q * W_SAX + 2 * Lp * W_SAX
                                          + Q * Lp)},
        "pairwise_l2": {"calls": SPANS,
                        "flops": SPANS * (2 * Q * X * n + 2 * (Q + X) * n
                                          + 4 * Q * X),
                        "bytes": SPANS * 4 * (Q * n + X * n + Q * X)}}
    assert cost.collective_counts == {
        "all-gather": {"count": 1, "bytes": (S - 1) * Q * K * 8}}
    assert cost.flops == sum(e["flops"] for e in cost.kernels.values())
    assert cost.host_syncs == {}


def test_exact_dtw_shared_cell_runs_the_cascade_per_sub_slab():
    """Each span cut into ``chunk / DTW_SUB`` sub-slabs, each through the
    three cascade kernels at ``[Q, DTW_SUB, n]``, every lane on."""
    from repro_torch.core.metric import default_band
    cost = _cell("dtw shared")
    r, sub = default_band(LENGTH), sd.DTW_SUB
    calls = SPANS * (CHUNK // sub)
    with FakeTensorMode():
        slab, q, env = _fake(sub, LENGTH), _fake(Q, LENGTH), _fake(Q, LENGTH)
        mask, cut = _fake(Q, sub, dtype=torch.bool), _fake(Q)
    assert cost.loops == {"span": SPANS}
    assert cost.kernels["lb_keogh"] == _times(
        _alone("lb_keogh", slab, env, env), calls)
    assert cost.kernels["lb_improved"] == _times(
        _alone("lb_improved", slab, q, env, env, r), calls)
    assert cost.kernels["dtw_band"] == _times(
        _alone("dtw_band", q, slab, mask, cut, r), calls)
    assert cost.kernels["lb_paa_interval"]["calls"] == 1


@pytest.mark.parametrize("order", ["dtw perq", "dtw cluster"])
def test_exact_dtw_lane_cells_count_their_stages(order):
    """Stage 1 once an LB slab of ``DTW_LB_CHUNK`` lanes; the seed DP once;
    the walk once a ``DTW_LANE_CHUNK`` chunk from rank k to the last lane,
    once for each of ``cluster``'s query groups (one for ``perq``), its
    trips summed over the groups in ``loops``."""
    cost = _cell(order)
    q = CELLS[order][1]
    groups = sd._cluster_groups(q) if order == "dtw cluster" else 1
    slabs = -(-TP // sd.DTW_LB_CHUNK)
    chunks = -(-(TP - K) // sd.DTW_LANE_CHUNK)
    assert (order, groups) in (("dtw perq", 1), ("dtw cluster", 4))
    assert cost.loops == {"lb_slab": slabs, "walk": groups * chunks}
    assert cost.kernels["lb_keogh"]["calls"] == slabs
    assert cost.kernels["lb_improved"]["calls"] == slabs
    assert cost.kernels["dtw_band"]["calls"] == 1 + groups * chunks
    assert "lb_paa_interval" not in cost.kernels and "pairwise_l2" not in \
        cost.kernels


# ---------------------------------------------------------------------------
# scaled against unrolled
# ---------------------------------------------------------------------------

def _span_unrolled(dev, s, prep, qs, k, metric):
    slabs, n_sub, win_lb, _, _ = sd._span_prologue(dev, s, prep, qs, metric)
    carry = sd._span_carry(qs.shape[0], k, qs.device)
    for i in range(win_lb.shape[1]):
        carry = sd._span_step(metric, qs, prep, slabs, win_lb, dev.chunk,
                              n_sub, carry, i, i * dev.chunk, 0, dev.chunk)
    return carry


def _walk_unrolled(db_s, ids_s, qs, order, lbi_s, lbk_s, topd, topi, r,
                   kseed):
    _, n_chunks, cols, carry = sd._walk_init(order, topd, topi, kseed)
    for c in range(n_chunks):
        carry = sd._walk_step(db_s, ids_s, qs, order, lbi_s, lbk_s, cols, r,
                              kseed, carry, c)
    return carry[:4] + (0,)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_scaled_cell_equals_the_unrolled_cell(name, monkeypatch):
    """The cell with every span, LB slab and walk chunk run one by one (the
    search's own stage-1 loop, the span and walk steps at their own
    offsets): the same work.  The lane walk's peak is higher unrolled by at
    most one carry's ``[Qg, k]`` distances and ids: the walk's caller-given
    first carry stays referenced while a later trip replaces its
    successor, which a single scaled trip never sees."""
    scaled = _cell(name)
    monkeypatch.setattr(D, "_shard_knn_counted", _span_unrolled)
    monkeypatch.setattr(D, "_lb_tables_counted", sd._lb_tables)
    monkeypatch.setattr(D, "_lane_walk_counted", _walk_unrolled)
    unrolled = _cell(name)
    assert unrolled.loops == {} and scaled.loops
    for f in ("flops", "flops_by_dtype", "flops_global", "hbm_bytes",
              "hbm_bytes_hi", "collective_bytes", "collective_counts",
              "kernels", "aten_ops", "dtypes", "host_syncs", "n_ops",
              "argument_bytes", "output_bytes"):
        assert getattr(scaled, f) == getattr(unrolled, f), f
    gap = unrolled.peak_bytes - scaled.peak_bytes
    if "perq" in name or "cluster" in name:
        q = CELLS[name][1]
        groups = sd._cluster_groups(q) if "cluster" in name else 1
        assert 0 <= gap <= 2 * (q // groups) * K * 4
    else:
        assert gap == 0


def test_degraded_cell_is_the_healthy_cell_plus_the_mask():
    """The last shard dead: the same kernels, FLOPs and HBM bytes; the
    aten ops the healthy cell's plus the mask's (the health vector's
    upload, its broadcasts, a ``where`` over each of the four merged
    lists), none fewer; one host sync, the upload."""
    healthy, degraded = _cell("ed"), _cell("ed degraded")
    for f in ("kernels", "flops", "hbm_bytes", "collective_counts",
              "loops"):
        assert getattr(degraded, f) == getattr(healthy, f), f
    more = Counter(degraded.aten_ops)
    more.subtract(healthy.aten_ops)
    assert min(more.values()) == 0
    extra = {op: n for op, n in more.items() if n}
    assert extra["aten.where.self"] == 4
    assert set(extra) <= {"aten.where.self", "aten.unsqueeze.default",
                          "aten.scalar_tensor.default",
                          "aten.lift_fresh.default", "prim.device.default"}
    assert degraded.host_syncs == {"Tensor.to": 1}
    single = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    one = D.lower_search_degraded(single, q_batch=Q, **KW).analyze()
    assert one.aten_ops == D.lower_search_sharded(
        single, q_batch=Q, **KW).analyze().aten_ops


# ---------------------------------------------------------------------------
# the cells in the dry run's records, and on a real layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["search_sharded", "search_dtw"])
def test_dumpy_cell_records_the_exact_kinds(kind):
    """``lower_dumpy_cell`` at the reference's 4 M × 256 on a small mesh:
    counted, a roofline, the loops' trip counts, nothing skipped."""
    from repro_torch.launch.dryrun import lower_dumpy_cell
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(64, 4))
    rec = lower_dumpy_cell(mesh, "small", kind, device="cpu")
    assert "skipped" not in rec and "error" not in rec
    assert rec["roofline"]["step_s"] > 0
    spans = (1 << 22) // 64 // 8192           # the chunk defaults to 8192
    assert rec["cost"]["loops"] == {"span": spans}
    kernel = "pairwise_l2" if kind == "search_sharded" else "dtw_band"
    subs = 1 if kind == "search_sharded" else 8192 // sd.DTW_SUB
    assert rec["cost"]["kernels"][kernel]["calls"] == spans * subs
    assert rec["collectives"]["per_kind"]["all-gather"]["count"] == 1


def test_dryrun_cells_counts_every_dumpy_cell():
    cells = D.dryrun_cells(MESH, device="cpu")
    assert {"dumpy_search_sharded", "dumpy_search_dtw"} <= set(cells)
    assert all(isinstance(c, op_cost.OpCost) for c in cells.values())
    assert cells["dumpy_search_sharded"].loops == {"span": (1 << 20) // 4
                                                   // 4096}


@pytest.mark.parametrize("entry,order", [("search_exact_ed", None),
                                         ("search_exact_dtw_lane",
                                          "cluster")])
def test_count_over_a_real_layout_bounds_the_real_search(entry, order):
    """``lower_exact_on`` over fake copies of the audit's real layout
    against a census of the real search on it: the loops' trips are the
    layout's spans and lanes, the kernels the census saw are the dry run's
    (the prune scan and the LB tables as many times, the distance kernels
    at least as many: the real loops stop early, the count does not)."""
    from repro_torch.analysis import contracts, registry
    from repro_torch.core.metric import resolve
    st = registry.audit_state("cpu")
    dev = st.dev()
    (e,) = registry.entries([entry])
    _, census = contracts.run_entry(e, "cpu")
    real = census.kernel_calls
    met = resolve("dtw" if order else "ed", dev.n, None, order)
    kk = sd._result_margin(dev, registry.AUDIT_K) + 8
    cost = D.lower_exact_on(dev, k=kk, q_batch=st.qs.shape[0],
                            metric=met).analyze()
    dry = {name: e["calls"] for name, e in cost.kernels.items()}
    Tp = dev.db.shape[1]
    if order is None:
        assert cost.loops == {"span": dev.win_start.shape[1]}
        assert dry["pairwise_l2"] == dev.win_start.shape[1] >= \
            real["pairwise_l2"]
        assert dry["lb_paa_interval"] == real["lb_paa_interval"] == 1
    else:
        slabs = sd._lb_trips(Tp)
        assert cost.loops["lb_slab"] == slabs
        assert dry["lb_keogh"] == real["lb_keogh"] == slabs
        assert dry["lb_improved"] == real["lb_improved"] == slabs
        assert dry["dtw_band"] >= real["dtw_band"]
    assert cost.argument_bytes >= sum(
        getattr(dev, f).numel() * getattr(dev, f).element_size()
        for f in ("db", "alive", "ids"))


# ---------------------------------------------------------------------------
# against the reference's hlo_cost on its own lowering
# ---------------------------------------------------------------------------

SPAN_LOOP = "jit(_exact_knn_sharded)/vmap()/while"


@pytest.mark.parametrize("name", sorted(CELLS))
def test_loops_against_the_reference(reference, name):
    """Each loop whose trip count the reference's ``hlo_cost`` reads has
    the port's: DTW ``shared``'s sub-slab loop is the port's kernel calls a
    span, the lane program's LB loop its ``lb_slab``.  The loops it reads
    none of are the port's scaled ones: one span loop, or one walk a query
    group, each counted once there and every trip here."""
    ref, cost = reference[name], _cell(name)
    read = [e["trips"] for e in ref["loops"] if e["trips"] is not None]
    unread = [e["op"] for e in ref["loops"] if e["trips"] is None]
    assert ref["unknown_loops"] >= len(unread) >= 1
    if name in ("ed", "ed degraded"):
        assert read == [] and unread == [SPAN_LOOP]
        assert cost.loops == {"span": SPANS}
    elif name == "dtw shared":
        assert unread == [SPAN_LOOP]
        assert read == [CHUNK // sd.DTW_SUB]
        for kernel in ("lb_keogh", "lb_improved", "dtw_band"):
            assert cost.kernels[kernel]["calls"] == SPANS * read[0]
    else:
        q = CELLS[name][1]
        groups = sd._cluster_groups(q) if name == "dtw cluster" else 1
        chunks = -(-(TP - K) // sd.DTW_LANE_CHUNK)
        assert read == [cost.loops["lb_slab"]] == [sd._lb_trips(TP)]
        assert unread == ["jit(_exact_knn_lane_sharded)/vmap()/while"] * \
            groups
        assert cost.loops["walk"] == groups * chunks


@pytest.mark.parametrize("name", sorted(CELLS))
def test_flops_against_the_reference(reference, name):
    """ED: the reference counts one span's matmul (its loop's trip count
    unread), the port W spans, within 18% (the module's docstring says
    why).  DTW: the reference's program has no ``dot``, so ``hlo_cost``
    counts no FLOP; the port counts its kernels' work."""
    ref, cost = reference[name], _cell(name)
    if name.startswith("ed"):
        assert ref["flops"] == 2 * Q * CHUNK * LENGTH
        assert cost.flops == pytest.approx(SPANS * ref["flops"], rel=0.18)
        assert cost.flops > SPANS * ref["flops"]
    else:
        assert ref["flops"] == 0 and cost.flops > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_collectives_against_the_reference(reference, name):
    """The port: one all-gather of (S − 1)·Q·k·8 bytes, nothing in its
    loops.  The reference: its merge outside the loops, each collective at
    most one shard's ``[Q, k]`` distances and ids; in each loop, an
    all-gather of every shard's ``[Q, pool + k]`` merge candidates (pool:
    the slab, the DTW sub-slab or the walk chunk) and one-byte all-reduces
    of the stop flags, which the port's shard-alone loops do not make."""
    ref, cost = reference[name], _cell(name)
    q = CELLS[name][1]
    assert cost.collective_counts == {
        "all-gather": {"count": 1, "bytes": (S - 1) * q * K * 8}}
    outside = ref["collectives"]["outside"]
    assert any(kind == "all-gather" for kind, _, _ in outside)
    assert max(nbytes for _, nbytes, _ in outside) <= q * K * 8
    pool = {"ed": CHUNK, "ed degraded": CHUNK,
            "dtw shared": sd.DTW_SUB}.get(name, sd.DTW_LANE_CHUNK)
    groups = sd._cluster_groups(q) if name == "dtw cluster" else 1
    gathers = [rt for kind, _, rt in ref["collectives"]["inside"]
               if kind == "all-gather"]
    assert len(gathers) == groups
    for rt in gathers:
        assert re.match(r"f32\[(\d+),(\d+),(\d+)\]", rt).groups() == (
            str(S), str(q // groups), str(pool + K))
    assert {(kind, nbytes) for kind, nbytes, _ in ref["collectives"]["inside"]
            if kind != "all-gather"} == {("all-reduce", 1)}
