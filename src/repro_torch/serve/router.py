"""Fleet router: prefix-aware placement of requests over N engine replicas.

Counterpart of ``repro/serve/router.py``, copied with the port's engine:
every replica of one fleet serves from the one
:class:`~repro_torch.models.transformer.Transformer` the fleet was given
(its weights are shared, as the reference's replicas share ``params``); a
respawn builds a fresh pool, bus and scheduler, never a copy of the
weights. The engines run on the fleet's ``device`` (``cuda`` unless the
caller asks for the CPU).

HEROv2's defining split is *one host orchestrating many accelerators*: the
host does not merely call a PULP cluster, it owns a fleet of them behind a
single programming interface and dispatches each offload where the data
already is. This module is the serving analogue — the first layer *above*
the Engine facade: a :class:`Fleet` owns N
:class:`~repro_torch.serve.replica.Replica` handles (each wrapping one
:class:`~repro_torch.serve.engine.Engine`), launches them, and routes every
incoming request by score:

  1. **Longest prefix match first.** Each replica exports its resident
     radix tree as a digest map (``PrefixCache.fingerprints()`` — rolling
     blake2b over page chunks, content-only so digests compare across
     processes); the router fingerprints the incoming prompt once
     (``prompt_fingerprints``) and scores each replica by the longest
     match (``longest_fingerprint_match``). Shared-prefix locality is the
     whole game: a follower placed where its prefix lives skips that
     prefix's prefill.
  2. **Least-occupied tie-break.** Equal matches (including the all-zero
     case on stacks without a prefix layer) fall back to the occupancy
     score from the replica's published gauges + live mailbox depth
     (:meth:`Replica.load`), then to replica index — so placement is a
     *deterministic* function of (digests, gauges, order), the property
     tests/test_torch_router.py pins.
  3. **Admission backpressure.** A request is only placed on a replica
     whose SLO policy answers ``may_admit`` (and which is READY); when no
     replica is open the request parks in the fleet's FIFO and the router
     re-tries next step — head-of-line, so fleet arrival order is
     preserved under backpressure.

Fault tolerance is routing's other half:

  * **Kill** (crash, or the injected :class:`~repro_torch.serve.replica.
    ReplicaFailure`): the fleet recovers every incomplete request the dead
    replica owned — resident AND queued — and prepends them to the pending
    FIFO in original arrival order. Re-submission to a sibling resets the
    request's stream state (``Scheduler.submit`` re-derives it), and greedy
    determinism guarantees the re-derived stream is bit-identical to what
    the dead replica would have produced. Zero requests lost, ever.
  * **Drain**: ``drain(name)`` stops admission and requeues only the
    *never-admitted* mailbox tail (``Scheduler.extract_unadmitted``) —
    residents hold pages and must finish on their owner. The replica
    tombstones itself once idle, keeping its engine so tests can run
    allocator ``audit()`` post-mortem. ``respawn(name)`` relaunches a dead
    replica with a fresh engine (same name, bumped generation).

Invariants the conformance suite (tests/test_torch_router.py, against the
reference's fleet) holds the fleet to:
the union of per-request token streams from an N-replica fleet is
bit-identical to a 1-replica run of the same mix; every submitted request
ends exactly one of finished/shed (typed verdict); placement is
deterministic given the same digests and gauges.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.models import transformer
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.prefix_cache import (longest_fingerprint_match,
                                            prompt_fingerprints)
from repro_torch.serve.replica import Replica, ReplicaFailure
from repro_torch.serve.scheduler import Request

ROUTERS = ("prefix", "round_robin")


class Fleet:
    """N replicas, one mailbox-in-front: prefix-aware request routing.

    ``engine_factory(name, generation) -> Engine`` overrides replica
    construction (tests inject fake engines); the default builds
    ``Engine(cfg, model, config=..., device=device)`` with the bus
    namespaced by the replica name so fleet-level snapshots don't collide.
    """

    def __init__(self, cfg: transformer.ModelConfig,
                 model: Optional[transformer.Transformer],
                 config: Optional[EngineConfig] = None, *,
                 replicas: int = 2, router: str = "prefix",
                 names: Optional[List[str]] = None,
                 engine_factory: Optional[
                     Callable[[str, int], Engine]] = None, device=None):
        if router not in ROUTERS:
            raise ValueError(f"router={router!r}: expected one of {ROUTERS}")
        if replicas < 1:
            raise ValueError(f"replicas={replicas}: need >= 1")
        self.cfg = cfg
        self.model = model
        self.config = (config or EngineConfig()).normalized()
        self.router = router
        if names is None:
            names = [f"r{i}" for i in range(replicas)]
        if len(names) != replicas or len(set(names)) != replicas:
            raise ValueError(f"names={names!r}: need {replicas} unique names")
        if engine_factory is None:
            def engine_factory(name: str, generation: int) -> Engine:
                return Engine(self.cfg, self.model, config=
                              dataclasses.replace(self.config,
                                                  metrics_namespace=name),
                              device=device)
        self.replicas: List[Replica] = [Replica(n, engine_factory)
                                        for n in names]
        for rep in self.replicas:
            rep.launch()
        self._by_name = {rep.name: rep for rep in self.replicas}
        # routing state -----------------------------------------------------
        self._pending: Deque[Request] = collections.deque()
        self._inflight: Dict[int, Tuple[Request, str]] = {}
        self._arrival: Dict[int, int] = {}    # seq_id -> fleet arrival index
        self._n_submitted = 0
        self._rr_cursor = 0
        self._shed_mark: Dict[str, int] = {n: 0 for n in names}
        self._finished_by: Dict[str, int] = {n: 0 for n in names}
        self.finished: List[Request] = []
        self.shed: List[Request] = []
        self.stats: Dict[str, Any] = {
            "routed": 0, "routed_prefix": 0, "routed_prefix_tokens": 0,
            "requeued_kill": 0, "requeued_drain": 0,
            "backpressure_waits": 0, "respawns": 0,
        }

    # -- host API ----------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Accept a request into the fleet (always succeeds — backpressure
        parks it in the fleet FIFO, it is never dropped) and try to place
        it immediately."""
        if req.seq_id in self._arrival:
            raise ValueError(f"duplicate seq_id {req.seq_id} submitted to "
                             "fleet (placement bookkeeping keys on it)")
        self._arrival[req.seq_id] = self._n_submitted
        self._n_submitted += 1
        self._pending.append(req)
        self._route_pending()
        return True

    @property
    def idle(self) -> bool:
        return not self._pending and all(rep.idle for rep in self.replicas)

    def step(self) -> List[Request]:
        """One fleet iteration: place what can be placed, then step every
        live replica (an injected failure is recovered inline — its
        requests requeue and continue on siblings this same call)."""
        self._route_pending()
        done: List[Request] = []
        for rep in self.replicas:
            if not rep.live:
                continue
            try:
                finished = rep.step()
            except ReplicaFailure:
                self._recover(rep)
                continue
            for req in finished:
                self._inflight.pop(req.seq_id, None)
                self.finished.append(req)
                self._finished_by[rep.name] += 1
                done.append(req)
            self._collect_shed(rep)
        return done

    def run(self, max_steps: int = 1000) -> List[Request]:
        out: List[Request] = []
        for _ in range(max_steps):
            if self.idle:
                break
            out.extend(self.step())
        return out

    # -- lifecycle operations ----------------------------------------------
    def kill(self, name: str) -> int:
        """Hard-kill a replica: recover every incomplete request it owned
        (resident and queued) into the pending FIFO, in arrival order.
        Returns the number of requeued requests."""
        rep = self._by_name[name]
        if not rep.live:
            raise RuntimeError(f"kill({name!r}): replica is {rep.state}")
        return self._recover(rep)

    def drain(self, name: str) -> int:
        """Graceful drain: stop admitting, requeue the never-admitted
        mailbox tail to siblings, let residents finish locally. The
        replica flips DEAD on its own once idle (engine kept for
        post-mortem audit). Returns the number of requeued requests."""
        rep = self._by_name[name]
        rep.start_drain()
        moved = rep.extract_unadmitted()
        for req in moved:
            self._inflight.pop(req.seq_id, None)
        self._requeue(moved)
        self.stats["requeued_drain"] += len(moved)
        self._route_pending()
        return len(moved)

    def respawn(self, name: str) -> Replica:
        """Relaunch a dead replica with a fresh engine (same name, bumped
        generation, clean allocator and bus)."""
        rep = self._by_name[name]
        rep.launch()                 # raises unless STARTING/DEAD
        self._shed_mark[name] = 0
        self.stats["respawns"] += 1
        self._route_pending()
        return rep

    # -- reporting ---------------------------------------------------------
    def stats_summary(self) -> Dict[str, Any]:
        """Engine-style stats with a ``fleet`` section on top and the
        per-replica Engine summaries underneath."""
        fleet = dict(self.stats)
        fleet.update(
            router=self.router,
            pending=len(self._pending),
            inflight=len(self._inflight),
            submitted=self._n_submitted,
            finished=len(self.finished),
            shed=len(self.shed),
            replicas={rep.name: {"state": rep.state,
                                 "generation": rep.generation,
                                 "finished": self._finished_by[rep.name]}
                      for rep in self.replicas})
        per_replica = {rep.name: rep.engine.stats_summary()
                       for rep in self.replicas if rep.engine is not None}
        return {"fleet": fleet, "per_replica": per_replica}

    def metrics_snapshot(self, ps=(50, 90, 99)) -> Dict[str, Any]:
        """``{replica_name: bus snapshot}`` — each stamped with its own
        namespace."""
        return {rep.name: rep.metrics_snapshot(ps)
                for rep in self.replicas if rep.engine is not None}

    # -- routing core -------------------------------------------------------
    def _route_pending(self) -> None:
        """Place pending requests head-of-line FIFO: stop at the first
        request no replica will take (admission backpressure) so fleet
        arrival order survives overload."""
        while self._pending:
            req = self._pending[0]
            placed = self._try_place(req)
            if not placed:
                self.stats["backpressure_waits"] += 1
                break
            self._pending.popleft()

    def _try_place(self, req: Request) -> bool:
        open_reps = [rep for rep in self.replicas if rep.admission_open()]
        if not open_reps:
            return False
        if self.router == "round_robin":
            rep, match = self._pick_round_robin(open_reps), 0
        else:
            rep, match = self._pick_prefix(req, open_reps)
        if not rep.submit(req):      # mailbox full (depth cap) — backpressure
            return False
        self._inflight[req.seq_id] = (req, rep.name)
        self.stats["routed"] += 1
        if match > 0:
            self.stats["routed_prefix"] += 1
            self.stats["routed_prefix_tokens"] += match
        return True

    def _pick_round_robin(self, open_reps: List[Replica]) -> Replica:
        rep = open_reps[self._rr_cursor % len(open_reps)]
        self._rr_cursor += 1
        return rep

    def _pick_prefix(self, req: Request,
                     open_reps: List[Replica]) -> Tuple[Replica, int]:
        """Longest fingerprint match, then least occupied, then index —
        a deterministic total order over (digests, gauges, replica order)."""
        candidates = prompt_fingerprints(req.prompt,
                                         self.config.cache.page_tokens)
        best: Optional[Tuple[Tuple[int, float, int], Replica, int]] = None
        for idx, rep in enumerate(open_reps):
            match = longest_fingerprint_match(candidates,
                                              rep.prefix_fingerprints())
            key = (-match, rep.load(), idx)
            if best is None or key < best[0]:
                best = (key, rep, match)
        assert best is not None
        return best[1], best[2]

    # -- failure recovery ---------------------------------------------------
    def _recover(self, rep: Replica) -> int:
        """Kill path: collect any final shed verdicts, gather every
        incomplete request the replica owned, tombstone it, and requeue
        the orphans (arrival order) for siblings."""
        self._collect_shed(rep)
        orphans = [req for _sid, (req, owner) in self._inflight.items()
                   if owner == rep.name and not req.done]
        for req in orphans:
            del self._inflight[req.seq_id]
        rep.mark_dead()
        self._requeue(orphans)
        self.stats["requeued_kill"] += len(orphans)
        self._route_pending()
        return len(orphans)

    def _requeue(self, reqs: List[Request]) -> None:
        """Prepend to the pending FIFO in fleet arrival order — recovered
        requests keep their place ahead of later arrivals."""
        ordered = sorted(reqs, key=lambda r: self._arrival[r.seq_id])
        self._pending.extendleft(reversed(ordered))

    def _collect_shed(self, rep: Replica) -> None:
        """Fold a replica's newly-shed requests (typed verdicts attached)
        into the fleet ledger; a shed request leaves the inflight map."""
        if rep.engine is None:
            return
        shed = rep.engine.shed
        mark = self._shed_mark[rep.name]
        for req in shed[mark:]:
            self._inflight.pop(req.seq_id, None)
            self.shed.append(req)
        self._shed_mark[rep.name] = len(shed)
