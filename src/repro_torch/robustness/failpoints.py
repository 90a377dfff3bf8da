"""Deterministic, seeded fault injection (docs/robustness.md).

A *failpoint* is a named site in the code — ``failpoint("index.save.commit")``
— that is a no-op until a test (or the ``DUMPY_FAILPOINTS`` env var) *arms*
it with an action.  The registry is process-global and deterministic: an
armed action fires on an exact hit count (or a seeded per-site RNG when a
probability is given), so every run of a fault-injection test replays the
same fault sequence.  This is the RocksDB/SQLite failpoint idiom brought to
the index's durability and device paths; the ParIS/MESSI line of parallel
data-series engines treats exactly this per-worker failure isolation as a
first-class design constraint.

Actions
-------
``crash``
    Raise :class:`InjectedCrash` — a ``BaseException`` so no ``except
    Exception`` cleanup handler on the way out can "un-tear" the state the
    crash is supposed to leave behind.  Simulates process death mid-
    operation; the test catches it at top level and then re-opens the
    artifact, exactly like a restart would.
``raise``
    Raise :class:`FailpointError` — a recoverable injected I/O fault, the
    kind :func:`with_retries` is allowed to retry.
``delay[:seconds]``
    Sleep (default 10 ms) and continue — for exercising timeout/overlap
    behaviour without faking clocks.
``flaky[:n]``
    Fail (``FailpointError``) the first ``n`` hits (default 1), then
    succeed forever — the canonical transient fault for retry tests.
``exit[:code]``
    ``os._exit`` — a real process kill for subprocess-driven tests where
    even ``BaseException`` unwinding is too graceful.

Any action takes optional ``p=<prob>`` / ``seed=<int>`` suffixes
(``"raise:p=0.25:seed=7"``) for seeded probabilistic firing, and a plain
integer suffix bounds how many times it fires (``"raise:2"`` = first two
hits only; for ``flaky`` the integer is the failure count before healing).

Arming
------
::

    from repro_torch.robustness import failpoints as fp

    with fp.armed({"index.save.commit": "crash"}):
        idx.save(path)                     # raises InjectedCrash

    fp.REGISTRY.arm("wal.append", "flaky:2")   # imperative form
    fp.REGISTRY.disarm()                       # clear everything

or from the environment (read once at import; subprocess smoke tests use
this): ``DUMPY_FAILPOINTS="index.save.commit=crash;wal.append=flaky:2"``.

Sites
-----
The canonical sites wired into the tree are listed in :data:`SITES`; the
registry accepts any string, so new sites need no central registration.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from contextlib import contextmanager

#: canonical failpoint sites wired into the tree (documentation, not a
#: closed set — see docs/robustness.md for what each site brackets)
SITES = (
    "index.save.begin",        # after stale-tmp cleanup, before any write
    "index.save.arrays",       # arrays.npz write (retried)
    "index.save.meta",         # meta.json write (retried)
    "index.save.manifest",     # manifest.json write (retried)
    "index.save.rename",       # before the gen-dir rename
    "index.save.commit",       # before the CURRENT pointer flip (the commit)
    "index.save.post_commit",  # after the flip, before generation pruning
    "index.save.prune",        # before old generations are deleted
    "index.load.verify",       # per-generation manifest/checksum verify
    "wal.append",              # before a WAL record hits the file (retried)
    "wal.append.tear",         # after *half* the record is written (crash)
    "device.put",              # DeviceIndex build/upload (retried)
    "search.shard_merge",      # before the sharded search program launches
    "serving.enqueue",         # CoalescingFrontend.submit, before queueing
    "serving.flush",           # before a coalesced bucket launches (retried)
)

ENV_VAR = "DUMPY_FAILPOINTS"

_EXIT_CODE = 66


class FailpointError(RuntimeError):
    """A recoverable injected fault (the ``raise``/``flaky`` actions)."""


class InjectedCrash(BaseException):
    """Simulated process death.  Deliberately *not* an ``Exception``: crash
    semantics must not be absorbed by ``except Exception`` cleanup on the
    unwind path — whatever state is on disk at the crash site is exactly
    what a restart will find."""


class RetriesExhausted(RuntimeError):
    """:func:`with_retries` gave up; ``__cause__`` is the last failure."""


@dataclasses.dataclass
class Action:
    kind: str                  # crash | raise | delay | flaky | exit
    times: int | None = None   # firing budget (flaky: failures before heal)
    delay: float = 0.01        # seconds (delay action)
    p: float = 1.0             # firing probability per hit
    seed: int = 0              # seeds the per-site RNG when p < 1
    code: int = _EXIT_CODE     # exit action status


_KINDS = ("crash", "raise", "delay", "flaky", "exit")


def parse_action(spec: str | Action) -> Action:
    """``"flaky:2"`` / ``"delay:0.05"`` / ``"raise:p=0.5:seed=7"`` → Action."""
    if isinstance(spec, Action):
        return spec
    parts = [p.strip() for p in str(spec).split(":") if p.strip()]
    if not parts or parts[0] not in _KINDS:
        raise ValueError(f"unknown failpoint action {spec!r}; "
                         f"kinds: {_KINDS}")
    act = Action(kind=parts[0])
    for tok in parts[1:]:
        if "=" in tok:
            key, val = tok.split("=", 1)
            if key == "p":
                act.p = float(val)
            elif key == "seed":
                act.seed = int(val)
            else:
                raise ValueError(f"unknown failpoint option {tok!r} in "
                                 f"{spec!r}")
        elif act.kind == "delay":
            act.delay = float(tok)
        elif act.kind == "exit":
            act.code = int(tok)
        else:
            act.times = int(tok)
    if act.kind == "flaky" and act.times is None:
        act.times = 1
    return act


@dataclasses.dataclass
class _Armed:
    action: Action
    hits: int = 0    # times the site was evaluated while armed
    fires: int = 0   # times the action actually fired
    rng: random.Random = None

    def __post_init__(self):
        self.rng = random.Random(self.action.seed)


class FailpointRegistry:
    """Process-global site → armed-action map (thread-safe)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._sites: dict[str, _Armed] = {}

    # -- arming -------------------------------------------------------------
    def arm(self, site: str, action: str | Action) -> None:
        with self._lock:
            self._sites[site] = _Armed(parse_action(action))

    def disarm(self, site: str | None = None) -> None:
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def arm_from_env(self, env: str | None = None) -> int:
        """Arm from ``DUMPY_FAILPOINTS`` (``site=action`` pairs split on
        ``;`` or ``,``); returns the number of sites armed."""
        spec = os.environ.get(ENV_VAR, "") if env is None else env
        n = 0
        for pair in spec.replace(",", ";").split(";"):
            pair = pair.strip()
            if not pair:
                continue
            site, _, action = pair.partition("=")
            self.arm(site.strip(), action.strip() or "raise")
            n += 1
        return n

    # -- introspection ------------------------------------------------------
    def is_armed(self, site: str) -> bool:
        return site in self._sites

    def hits(self, site: str) -> int:
        with self._lock:
            armed = self._sites.get(site)
            return armed.hits if armed else 0

    def fires(self, site: str) -> int:
        with self._lock:
            armed = self._sites.get(site)
            return armed.fires if armed else 0

    # -- the site call ------------------------------------------------------
    def evaluate(self, site: str) -> None:
        with self._lock:
            armed = self._sites.get(site)
            if armed is None:
                return
            armed.hits += 1
            act = armed.action
            if act.p < 1.0 and armed.rng.random() >= act.p:
                return
            if act.kind == "flaky":
                if armed.fires >= act.times:
                    return                       # healed
                armed.fires += 1
                raise FailpointError(
                    f"failpoint {site!r}: injected transient failure "
                    f"{armed.fires}/{act.times}")
            if act.times is not None and armed.fires >= act.times:
                return
            armed.fires += 1
            kind = act.kind
        # fire outside the lock (sleep/exit must not hold it)
        if kind == "delay":
            time.sleep(act.delay)
        elif kind == "raise":
            raise FailpointError(f"failpoint {site!r}: injected failure")
        elif kind == "crash":
            raise InjectedCrash(f"failpoint {site!r}: injected crash")
        elif kind == "exit":
            os._exit(act.code)


REGISTRY = FailpointRegistry()
REGISTRY.arm_from_env()


def failpoint(site: str) -> None:
    """Evaluate a failpoint site.  Free when nothing is armed (one dict
    check) — safe to leave in production paths."""
    if not REGISTRY._sites:
        return
    REGISTRY.evaluate(site)


def is_armed(site: str) -> bool:
    return REGISTRY.is_armed(site)


@contextmanager
def armed(sites: dict[str, str | Action] | None = None, **kw):
    """Scoped arming: ``with armed({"wal.append": "flaky:2"}): ...`` (or
    keyword form with ``__`` for dots: ``armed(wal__append="flaky:2")``).
    Only the named sites are disarmed on exit, so nesting composes."""
    spec = dict(sites or {})
    spec.update({k.replace("__", "."): v for k, v in kw.items()})
    for site, action in spec.items():
        REGISTRY.arm(site, action)
    try:
        yield REGISTRY
    finally:
        for site in spec:
            REGISTRY.disarm(site)


def with_retries(fn, *, retries: int = 3, backoff: float = 0.005,
                 max_backoff: float = 0.25,
                 retry_on: tuple = (FailpointError, OSError),
                 site: str | None = None):
    """Call ``fn()`` with deterministic exponential backoff on transient
    faults.  ``retries`` is the number of *re*-tries (so up to
    ``retries + 1`` attempts); only ``retry_on`` exceptions are retried —
    :class:`InjectedCrash` is a ``BaseException`` and always propagates,
    exactly like real process death would.  Exhaustion raises
    :class:`RetriesExhausted` chained to the last failure."""
    delay = backoff
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as err:
            if attempt == retries:
                raise RetriesExhausted(
                    f"{site or getattr(fn, '__name__', 'call')}: "
                    f"{attempt + 1} attempt(s) failed: {err}") from err
            time.sleep(delay)
            delay = min(delay * 2, max_backoff)
