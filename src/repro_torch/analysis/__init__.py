"""Contract audit of the port's entry points: a static and runtime gate over
every program the port runs on the card (port of ``repro.analysis``).

The subsystem has the reference's four legs, in eager PyTorch's idiom:

* ``registry``  — declarative map of every entry point the reference audits
  (the same eleven names: the exact searches, extended, approximate, the
  one-shot scan, both build-stage programs, the serving head and bucket) to
  a runnable call at fixed *audit shapes*, plus per-entry policy flags.
* ``contracts`` — run one entry under a census (``TorchDispatchMode`` and
  ``TorchFunctionMode``) and extract its *contract*: kernel calls, eager
  aten ops, result dtypes, host syncs, device moves and peak bytes; diff it
  against the committed golden ``contracts_torch.json``.
* ``lint``      — AST linter for the port's hazards: implicit device→host
  syncs inside the loops of ``core/``, ``serving/`` and ``kernels/``, and
  ``perf_counter`` windows that never synchronize.
* ``recompile`` — the steady-state sweep: the k/nbr/metric/batch grid and
  the serving bucket ladder run twice, and the second pass must build
  nothing and repeat the first pass's kernel calls, eager ops and syncs.

Plus ``guards.no_host_sync()``, the twin of the reference's
``guard_transfers`` test marker.

CLI gates::

    PYTHONPATH=src python -m repro_torch.analysis.lint [paths ...]
    PYTHONPATH=src python -m repro_torch.analysis.audit [--update] [--device cpu|cuda]

Importing this package imports nothing else: it never initialises CUDA and
never builds the kernels.
"""
