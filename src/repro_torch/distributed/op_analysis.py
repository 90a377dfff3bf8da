"""Censuses of a dry run's op stream (port of
``repro.distributed.hlo_analysis``, which reads compiled HLO text).

They read the :class:`~repro_torch.distributed.op_cost.OpCost` that
``op_cost.analyze`` recorded, whose dispatch mode is the analysis gates'
``Census``:

* :func:`collective_stats` — count and operand bytes of each collective
  kind (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``)
  and their total, the roofline's collective numerator;
* :func:`op_census` — the most frequent aten ops (a recomputation or
  redundancy signal);
* :func:`dtype_census` — the op results per dtype (a ``float64`` here is a
  double leaked into a device program).

The reference's ``host_call_stats`` (host callbacks, infeed, outfeed) and
``control_flow_stats`` (``while`` / ``conditional`` ops) describe an XLA
module.  Their counterparts in an eager program are :func:`host_syncs`,
the census's predicted host syncs, and the data-dependent reads that stop
a dry run: on fake tensors a read of a value the device computed raises,
and the cell records it.  A Python loop is unrolled into the op stream, or
its body counted once a trip (``op_cost.scaled``, recorded in
``OpCost.loops``) where host reads drive it, as in Dumpy's exact cells.
"""
from __future__ import annotations

from .op_cost import OpCost


def collective_stats(cost: OpCost) -> dict:
    """Per-kind ``{"count", "bytes"}`` and the total bytes."""
    return {"per_kind": {k: dict(v) for k, v in
                         sorted(cost.collective_counts.items())},
            "total_bytes": cost.collective_bytes}


def op_census(cost: OpCost, top: int | None = 15) -> list[tuple[str, int]]:
    """The most frequent aten ops, most frequent first (``top=None``: all
    of them)."""
    ranked = sorted(cost.aten_ops.items(), key=lambda kv: (-kv[1], kv[0]))
    return ranked if top is None else ranked[:top]


def dtype_census(cost: OpCost) -> dict:
    """Count of op results per dtype."""
    return dict(cost.dtypes)


def host_syncs(cost: OpCost) -> dict:
    """The predicted host syncs by torch call (the counterpart of
    ``host_call_stats``)."""
    return dict(cost.host_syncs)
