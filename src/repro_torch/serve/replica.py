"""Replica handle: one Engine behind the fleet lifecycle state machine.

Counterpart of ``repro/serve/replica.py``, copied with the port's
:class:`~repro_torch.serve.engine.Engine` in place of the reference's.

HEROv2's host owns a *fleet* of PULP clusters behind one programming
interface — the host-side handle for each cluster tracks where it is in its
lifecycle (loading its binary, accepting offloads, being quiesced for a
reload) so the dispatcher never hands work to an accelerator that cannot
take it. This module is the serving analogue: a :class:`Replica` wraps one
:class:`~repro_torch.serve.engine.Engine` and exposes exactly the surface the
:class:`~repro_torch.serve.router.Fleet` needs, behind four states::

    STARTING --launch()--> READY --start_drain()--> DRAINING --idle--> DEAD
        ^                    |                                          |
        |                    +------------- kill / failure -------------+
        +--------------------------- launch() (respawn) ----------------+

Ownership boundaries & invariants:

  * **The Replica owns lifecycle, the Engine owns execution.** Nothing here
    touches scheduler/cache/executor internals except through the Engine's
    public facade plus two sanctioned fleet hooks: ``Scheduler.
    extract_unadmitted()`` (drain) and the read-only routing signals below.
  * **Engines are born from a factory, not held forever**: ``launch()``
    calls ``engine_factory(name, generation)`` so a respawned replica gets
    a *fresh* engine (new allocator, new bus namespaced by the same replica
    name) while the corpse of a killed one is dropped — respawn never
    resurrects poisoned state. ``generation`` counts launches.
  * **Routing signals are cheap and side-effect-free**: ``load()`` reads
    published gauges (falling back to live scheduler counts when the bus
    is disabled or has not published yet), ``prefix_fingerprints()``
    returns the resident radix tree's digest map without LRU ticks, and
    ``admission_open()`` asks the SLO policy's ``may_admit`` without
    mutating it. The router may call all three every request.
  * **Fault injection is a first-class hook**: ``fail_after(n)`` arms a
    crash that raises :class:`ReplicaFailure` at the *top* of the n-th
    subsequent ``step()`` — before any device work — so a killed replica
    looks exactly like one that died between iterations, the failure model
    the conformance tests (tests/test_torch_router.py) reason about.
  * A DRAINING replica transitions itself to DEAD when its engine goes
    idle; a drained corpse *keeps* its engine so tests can run allocator
    ``audit()`` post-mortem. A killed replica's engine is detached by the
    fleet after orphan recovery (``mark_dead()``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request

# lifecycle states (strings, not an Enum: they go straight into stats JSON)
STARTING = "starting"
READY = "ready"
DRAINING = "draining"
DEAD = "dead"


class ReplicaFailure(RuntimeError):
    """An armed fault-injection hook fired (or the engine died mid-step).

    Carries the replica's name so the Fleet knows whose requests to
    requeue. Raised from :meth:`Replica.step` *before* device work, never
    from the routing signals."""

    def __init__(self, name: str, msg: str = "injected failure"):
        super().__init__(f"replica {name!r}: {msg}")
        self.name = name


class Replica:
    """One engine behind the starting→ready→draining→dead state machine.

    ``engine_factory(name, generation) -> Engine`` builds the engine;
    respawn calls it again with a bumped generation.
    """

    def __init__(self, name: str,
                 engine_factory: Callable[[str, int], Engine]):
        self.name = name
        self._factory = engine_factory
        self.engine: Optional[Engine] = None
        self.state = STARTING
        self.generation = 0          # launches so far; bumped by launch()
        self._fail_in: Optional[int] = None

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return (f"Replica({self.name!r}, state={self.state}, "
                f"gen={self.generation})")

    # -- lifecycle ---------------------------------------------------------
    def launch(self) -> Engine:
        """STARTING/DEAD → READY with a fresh engine from the factory."""
        if self.state not in (STARTING, DEAD):
            raise RuntimeError(f"replica {self.name!r}: launch() from "
                               f"{self.state} (already live)")
        self.engine = self._factory(self.name, self.generation)
        self.generation += 1
        self._fail_in = None
        self.state = READY
        return self.engine

    def start_drain(self) -> None:
        """READY → DRAINING: stop admitting; residents finish here. An
        already-idle replica tombstones immediately (there is nothing to
        finish, and the fleet's run loop never steps idle replicas), with
        its engine kept for post-mortem audit like any drained corpse."""
        if self.state != READY:
            raise RuntimeError(f"replica {self.name!r}: start_drain() from "
                               f"{self.state}")
        self.state = DEAD if self.idle else DRAINING

    def mark_dead(self) -> None:
        """Detach the engine and tombstone the replica (the kill path —
        called by the Fleet after it has recovered the orphaned requests).
        A DRAINING replica that empties naturally keeps its engine."""
        self.state = DEAD
        self.engine = None
        self._fail_in = None

    # -- fault injection ---------------------------------------------------
    def fail_after(self, n_steps: int) -> None:
        """Arm a crash: the ``n_steps``-th subsequent :meth:`step` raises
        :class:`ReplicaFailure` before doing any work (n=1 → next step)."""
        if n_steps < 1:
            raise ValueError(f"fail_after({n_steps}): need n >= 1")
        self._fail_in = int(n_steps)

    # -- routing signals (side-effect-free; router may poll every request) -
    @property
    def live(self) -> bool:
        return self.state in (READY, DRAINING) and self.engine is not None

    def admission_open(self) -> bool:
        """True when the router may place a new request here: READY and
        the SLO policy (if any) would admit one more in-system request."""
        if self.state != READY or self.engine is None:
            return False
        sch = self.engine.scheduler
        if sch.policy is None:
            return True
        return sch.policy.may_admit(sch._in_system())

    def load(self) -> float:
        """Occupancy score for least-loaded tie-breaking: published
        ``in_system`` gauge (live scheduler count when the bus is disabled
        or has not published yet) plus the *live* mailbox depth — live so
        several same-step placements spread instead of piling onto the
        replica whose gauges are one iteration stale."""
        eng = self.engine
        if eng is None:
            return float("inf")
        gauge = eng.bus.gauges.get("in_system") if eng.bus.enabled else None
        in_system = (gauge.value if gauge is not None
                     else eng.scheduler._in_system())
        return float(in_system) + float(len(eng.mailbox))

    def prefix_fingerprints(self) -> Dict[bytes, int]:
        """The resident radix tree's digest→covered-tokens map (empty when
        the stack has no prefix layer). Read-only: no LRU ticks."""
        eng = self.engine
        if eng is None or eng.prefix is None:
            return {}
        return eng.prefix.fingerprints()

    def metrics_snapshot(self, ps=(50, 90, 99)) -> Dict[str, Any]:
        return {} if self.engine is None else self.engine.metrics_snapshot(ps)

    # -- execution (delegates; fleet drives these) -------------------------
    def submit(self, req: Request) -> bool:
        if self.state != READY or self.engine is None:
            raise RuntimeError(f"replica {self.name!r}: submit() while "
                               f"{self.state}")
        return self.engine.submit(req)

    @property
    def idle(self) -> bool:
        return self.engine is None or self.engine.idle

    def step(self) -> List[Request]:
        """One engine iteration. Fires the armed failure hook first (the
        between-iterations crash model); transitions DRAINING → DEAD once
        the engine has fully emptied (corpse keeps its engine for
        post-mortem ``audit()``)."""
        if self.engine is None or self.state == DEAD:
            return []
        if self._fail_in is not None:
            self._fail_in -= 1
            if self._fail_in <= 0:
                self._fail_in = None
                raise ReplicaFailure(self.name)
        finished = self.engine.step()
        if self.state == DRAINING and self.engine.idle:
            self.state = DEAD
        return finished

    def extract_unadmitted(self) -> List[Request]:
        """Drain hook: pull every never-admitted mailbox request (they
        hold no engine state) for requeueing on siblings."""
        if self.engine is None:
            return []
        return self.engine.scheduler.extract_unadmitted()
