"""The chaos plane: deterministic fault injection for the emulated fabrics.

The port's copy of ``accl_tpu/faults.py``, whole: the same plans, rules,
actions and environment round trip, so a plan written by either package
loads in the other and replays to the same verdicts.  The port's gang
reaches the injector only through ``contract.install_fault_plan``.

The reference's failure machinery — the ``NOT_READY_ERROR`` retry stream
(``ccl_offload_control.c:2460-2478``), the error-code bitmask
(``constants.hpp:355-393``), ``check_return_value`` — exists so a lossy,
stalling network produces *diagnosable error codes* instead of hangs.  This
module supplies the lossy network: a serializable, seeded :class:`FaultPlan`
of :class:`FaultRule` s installed on a fabric (``InProcFabric`` /
``SocketFabric``), matched against every message on the send path.

Actions:

* ``drop``      — the message vanishes (a lossy link)
* ``delay``     — delivery postponed by ``delay_s`` (a congested link)
* ``duplicate`` — the message is transmitted twice (a retransmitting NIC)
* ``corrupt``   — payload bytes flipped; the wire checksum (``Message.csum``)
  still carries the ORIGINAL digest, so the receiving dataplane detects and
  discards it (bit errors on the wire)
* ``kill_rank`` — the rule's ``rank`` dies: its outbound traffic vanishes
  and sends addressed to it raise :class:`PeerDeadError` (fast failure, the
  engine converts it to ``SEND_TIMEOUT``)
* ``partition`` — the fabric splits into ``groups``; traffic crossing the
  cut vanishes silently in both directions
* ``diverge``   — the rule's ``rank`` (comm-relative, like every rank
  field here) has its collective-call fingerprints deterministically
  perturbed (contract plane, ``accl_tpu_torch.contract``): the wire is
  untouched, but the cross-rank runtime verifier sees that rank's call
  sequence diverge — the seeded proof that ``ACCL_VERIFY=1`` catches
  real SPMD divergence instead of hanging

Determinism: rule firing is driven purely by per-rule match counters
(``nth`` / ``count``) and corruption bytes by the plan-seeded RNG, so the
same plan against the same traffic replays to the same outcome.  Plans
round-trip through JSON and the ``ACCL_FAULT_PLAN`` environment variable,
which the one-process-per-rank ``SocketFabric`` tier reads at construction.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import random
import threading
from typing import Dict, List, Optional, Set, Tuple

#: environment variable holding a JSON-serialized FaultPlan; read by
#: SocketFabric so spawned per-rank processes inherit the plan
FAULT_PLAN_ENV = "ACCL_FAULT_PLAN"


class PeerDeadError(RuntimeError):
    """A send addressed a dead/detached endpoint.  The engine converts this
    into a fast SEND_TIMEOUT completion instead of waiting out the call
    deadline (the silent-drop failure mode noted at fabric.py:222)."""

    def __init__(self, address: str):
        self.address = address
        super().__init__(f"peer at {address} is dead/detached")


class FaultAction(str, enum.Enum):
    DROP = "drop"
    DELAY = "delay"
    DUPLICATE = "duplicate"
    CORRUPT = "corrupt"
    KILL_RANK = "kill_rank"
    PARTITION = "partition"
    DIVERGE = "diverge"


@dataclasses.dataclass
class FaultRule:
    """One matchable fault.

    Match fields (``None`` = wildcard): ``comm`` (communicator id), ``src`` /
    ``dst`` (comm-relative ranks from the message header), ``tag``,
    ``msg_type`` (a ``MsgType`` name like ``"EAGER"`` or its int value).

    Firing: the rule counts matching messages; it applies from the
    ``nth`` matching occurrence on (1-based, default 1) for at most
    ``count`` applications (``None`` = unlimited).  ``nth=0`` makes
    ``kill_rank`` / ``partition`` active from installation, with no
    trigger message required.

    Action parameters: ``delay_s`` (delay), ``rank`` (kill_rank, the
    comm-relative rank to kill), ``groups`` (partition, a list of rank
    lists defining the islands).

    Bounded duration: ``partition``/``drop`` rules may carry an
    optional ``heal_after`` occurrence count — after the rule has
    dropped that many messages its standing damage clears ITSELF (the
    partition island is removed / the drop rule deactivates) and a
    ``healed`` event is logged.  Healing is counter-driven like firing,
    so the same plan against the same traffic heals at the same
    message — which is what makes join-after-partition soaks
    replayable without out-of-band plan surgery.
    """

    action: FaultAction
    comm: Optional[int] = None
    src: Optional[int] = None
    dst: Optional[int] = None
    tag: Optional[int] = None
    msg_type: Optional[object] = None  # MsgType name (str) or int value
    nth: int = 1
    count: Optional[int] = None
    delay_s: float = 0.1
    rank: Optional[int] = None
    groups: Optional[List[List[int]]] = None
    heal_after: Optional[int] = None

    def __post_init__(self):
        self.action = FaultAction(self.action)
        if self.action == FaultAction.KILL_RANK and self.rank is None:
            raise ValueError("kill_rank rule needs a rank")
        if self.action == FaultAction.DIVERGE and self.rank is None:
            raise ValueError("diverge rule needs a rank")
        if self.action == FaultAction.PARTITION and not self.groups:
            raise ValueError("partition rule needs groups")
        if self.heal_after is not None:
            if self.action not in (FaultAction.PARTITION, FaultAction.DROP):
                raise ValueError(
                    "heal_after only applies to partition/drop rules"
                )
            if int(self.heal_after) < 1:
                raise ValueError("heal_after must be a positive count")
            self.heal_after = int(self.heal_after)

    def matches(self, msg) -> bool:
        if self.comm is not None and msg.comm_id != self.comm:
            return False
        if self.src is not None and msg.src != self.src:
            return False
        if self.dst is not None and msg.dst != self.dst:
            return False
        if self.tag is not None and msg.tag != self.tag:
            return False
        if self.msg_type is not None:
            mt = msg.msg_type
            if isinstance(self.msg_type, str):
                if getattr(mt, "name", str(mt)) != self.msg_type:
                    return False
            elif int(mt) != int(self.msg_type):
                return False
        return True

    def to_dict(self) -> dict:
        d = {"action": self.action.value}
        for f in ("comm", "src", "dst", "tag", "msg_type", "count",
                  "rank", "groups", "heal_after"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        if self.nth != 1:
            d["nth"] = self.nth
        if self.action == FaultAction.DELAY:
            d["delay_s"] = self.delay_s
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        return cls(**d)


@dataclasses.dataclass
class FaultPlan:
    """A seeded, serializable list of fault rules."""

    rules: List[FaultRule] = dataclasses.field(default_factory=list)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]},
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(
            rules=[FaultRule.from_dict(r) for r in d.get("rules", [])],
            seed=int(d.get("seed", 0)),
        )

    def to_env(self) -> str:
        """The value to place in ``ACCL_FAULT_PLAN`` so one-process-per-rank
        fabrics pick the plan up at construction."""
        return self.to_json()

    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultPlan"]:
        text = (environ or os.environ).get(FAULT_PLAN_ENV)
        if not text:
            return None
        return cls.from_json(text)


class _Verdict:
    """What the injector decided for one message."""

    __slots__ = ("drop", "dead_dst", "duplicate", "corrupt", "delay_s")

    def __init__(self):
        self.drop = False
        self.dead_dst = False
        self.duplicate = False
        self.corrupt = False
        self.delay_s = 0.0


class FaultInjector:
    """Runtime state of an installed :class:`FaultPlan` on one fabric.

    Thread-safe (multiple rank engines share the InProc fabric).  Keeps a
    bounded log of applied faults for replay/determinism assertions and
    per-rule fire counters for introspection.
    """

    _LOG_CAP = 10000

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._disabled = False
        self._matched = [0] * len(plan.rules)
        self.applied = [0] * len(plan.rules)
        self._rng = random.Random(plan.seed)
        self.log: List[dict] = []
        # (comm_scope, rank) pairs currently dead; comm_scope is the rule's
        # comm match (None = any communicator)
        self._dead: Set[Tuple[Optional[int], int]] = set()
        # active partitions: (comm_scope, rank -> island index, rule idx)
        self._partitions: List[
            Tuple[Optional[int], Dict[int, int], Optional[int]]
        ] = []
        # heal_after bookkeeping: per-rule occurrence counters and the
        # healed latch (a healed rule never fires again this install)
        self._heal_ctr = [0] * len(plan.rules)
        self.healed = [False] * len(plan.rules)
        for i, rule in enumerate(plan.rules):
            if rule.nth == 0:
                if rule.action == FaultAction.KILL_RANK:
                    self._dead.add((rule.comm, rule.rank))
                elif rule.action == FaultAction.PARTITION:
                    self._partitions.append(
                        (rule.comm, self._island_map(rule.groups), i)
                    )

    @staticmethod
    def _island_map(groups: List[List[int]]) -> Dict[int, int]:
        return {r: i for i, grp in enumerate(groups) for r in grp}

    # -- queries -------------------------------------------------------------
    def rank_dead(self, comm_id: int, rank: int) -> bool:
        with self._lock:
            return (None, rank) in self._dead or (comm_id, rank) in self._dead

    def dead_ranks(self) -> List[int]:
        """Ranks currently killed by standing ``kill_rank`` state (any
        comm scope) — the membership plane's chaos-evidence query: a
        seeded plan's eviction set is reproducible from it."""
        with self._lock:
            return sorted({r for (_scope, r) in self._dead})

    def clear(self) -> None:
        """Heal the network: deactivate kills/partitions and stop firing
        rules (counters keep their history for inspection)."""
        with self._lock:
            self._dead.clear()
            self._partitions.clear()
            self._disabled = True

    # -- the send-path hook --------------------------------------------------
    def on_send(self, msg) -> _Verdict:
        v = _Verdict()
        with self._lock:
            if self._disabled:
                return v
            # standing network state first: dead ranks and partitions
            if self._is_dead(msg.comm_id, msg.dst):
                v.dead_dst = True
                self._log("dead_dst", None, msg)
                return v
            if self._is_dead(msg.comm_id, msg.src):
                v.drop = True
                self._log("dead_src_drop", None, msg)
                return v
            part = self._which_partition(msg)
            if part is not None:
                ridx = self._partitions[part][2]
                v.drop = True
                self._log("partition_drop", ridx, msg)
                self._count_heal(ridx, part, msg)
                return v
            for i, rule in enumerate(self.plan.rules):
                if rule.action in (FaultAction.KILL_RANK,
                                   FaultAction.PARTITION) and rule.nth == 0:
                    continue  # install-time rules never fire per-message
                if rule.action == FaultAction.DIVERGE:
                    continue  # fires on fingerprints, not wire messages
                if self.healed[i]:
                    continue  # a self-healed rule never fires again
                if not rule.matches(msg):
                    continue
                self._matched[i] += 1
                if self._matched[i] < max(rule.nth, 1):
                    continue
                if rule.count is not None and self.applied[i] >= rule.count:
                    continue
                self.applied[i] += 1
                self._log(rule.action.value, i, msg)
                if rule.action == FaultAction.DROP:
                    v.drop = True
                    self._count_heal(i, None, msg)
                    return v
                if rule.action == FaultAction.DELAY:
                    v.delay_s = max(v.delay_s, float(rule.delay_s))
                elif rule.action == FaultAction.DUPLICATE:
                    v.duplicate = True
                elif rule.action == FaultAction.CORRUPT:
                    v.corrupt = True
                elif rule.action == FaultAction.KILL_RANK:
                    self._dead.add((rule.comm, rule.rank))
                    if msg.dst == rule.rank:
                        v.dead_dst = True
                        return v
                elif rule.action == FaultAction.PARTITION:
                    island = self._island_map(rule.groups)
                    self._partitions.append((rule.comm, island, i))
                    part = self._which_partition(msg)
                    if part is not None:
                        v.drop = True
                        self._count_heal(
                            self._partitions[part][2], part, msg
                        )
                        return v
        return v

    def _is_dead(self, comm_id: int, rank: int) -> bool:
        return (None, rank) in self._dead or (comm_id, rank) in self._dead

    def _which_partition(self, msg) -> Optional[int]:
        """Index of the first active partition this message crosses,
        None when it crosses none."""
        for p, (comm_scope, island, _ridx) in enumerate(self._partitions):
            if comm_scope is not None and msg.comm_id != comm_scope:
                continue
            a, b = island.get(msg.src), island.get(msg.dst)
            if a is not None and b is not None and a != b:
                return p
        return None

    def _count_heal(self, ridx: Optional[int], part: Optional[int],
                    msg) -> None:
        """One ``heal_after`` occurrence for rule ``ridx`` (caller holds
        the lock).  Reaching the count clears the rule's standing
        damage: the partition island at ``part`` is removed, a drop
        rule latches healed — deterministic, since occurrences are the
        dropped messages themselves."""
        if ridx is None:
            return
        rule = self.plan.rules[ridx]
        if rule.heal_after is None or self.healed[ridx]:
            return
        self._heal_ctr[ridx] += 1
        if self._heal_ctr[ridx] < rule.heal_after:
            return
        self.healed[ridx] = True
        if part is not None:
            self._partitions.pop(part)
        self._log("healed", ridx, msg)

    def on_fingerprint(self, comm_id: int, rank: int) -> int:
        """The contract plane's hook (``accl_tpu_torch.contract``): a nonzero
        XOR mask when a ``diverge`` rule fires for this rank's next
        collective-call fingerprint, 0 otherwise.  Deterministic: the
        mask derives from the plan seed + rank (same plan, same
        divergence), and firing follows the same ``nth``/``count``
        counters as the wire actions."""
        import zlib as _zlib

        with self._lock:
            if self._disabled:
                return 0
            for i, rule in enumerate(self.plan.rules):
                if rule.action != FaultAction.DIVERGE:
                    continue
                if rule.rank != rank:
                    continue
                if rule.comm is not None and rule.comm != comm_id:
                    continue
                self._matched[i] += 1
                if self._matched[i] < max(rule.nth, 1):
                    continue
                if rule.count is not None and self.applied[i] >= rule.count:
                    continue
                self.applied[i] += 1
                if len(self.log) < self._LOG_CAP:
                    self.log.append({
                        "action": FaultAction.DIVERGE.value,
                        "rule": i,
                        "msg_type": "FINGERPRINT",
                        "comm": comm_id,
                        "src": rank,
                        "dst": None,
                        "tag": None,
                        "seqn": self._matched[i] - 1,
                    })
                # any nonzero mask diverges; derive it from the seed so
                # two plans with different seeds perturb differently
                mask = _zlib.crc32(
                    f"diverge|{self.plan.seed}|{rank}".encode()
                ) | 1
                return mask
        return 0

    def corrupt_payload(self, payload: bytes) -> bytes:
        """Flip one byte at a plan-seeded position (deterministic given the
        same sequence of corruption events)."""
        if not payload:
            return payload
        with self._lock:
            pos = self._rng.randrange(len(payload))
            flip = self._rng.randrange(1, 256)
        out = bytearray(payload)
        out[pos] ^= flip
        return bytes(out)

    def _log(self, action: str, rule_index, msg) -> None:
        if len(self.log) >= self._LOG_CAP:
            return
        self.log.append({
            "action": action,
            "rule": rule_index,
            "msg_type": getattr(msg.msg_type, "name", str(msg.msg_type)),
            "comm": msg.comm_id,
            "src": msg.src,
            "dst": msg.dst,
            "tag": msg.tag,
            "seqn": msg.seqn,
        })

    def stats(self) -> dict:
        """Fire counters for introspection AND the telemetry snapshot
        (``telemetry_snapshot()["faults"]``): per-rule matched/applied,
        per-action fire totals, standing network damage."""
        with self._lock:
            by_action: Dict[str, int] = {}
            for ev in self.log:
                by_action[ev["action"]] = by_action.get(ev["action"], 0) + 1
            return {
                "matched": list(self._matched),
                "applied": list(self.applied),
                "fired_total": sum(self.applied),
                "by_action": by_action,
                "events": len(self.log),
                "dead": sorted(self._dead),
                "partitions": len(self._partitions),
                "healed": list(self.healed),
            }


#: the peer-health state machine's vocabulary (the gang's ok/suspect/dead
#: plus the membership plane's acting states) — transition EDGES over
#: these states are what HealthTransitions records
HEALTH_STATES = ("ok", "suspect", "dead", "demoted", "evicted", "restored")

#: bounded health-event ring capacity (telemetry_snapshot()
#: ["health_events"]["events"])
_HEALTH_EVENT_CAP = 128


class HealthTransitions:
    """Bounded record of health-map state *transitions* — the
    flap-visibility satellite: the instantaneous health map cannot show
    an ok→suspect→ok flap that self-clears between scrapes, so every
    edge is counted (``accl_health_transitions_total{peer,from,to}``)
    and the last N edges ride a bounded event ring into
    ``telemetry_snapshot()["health_events"]``.

    Fed by the engines' health accounting (emulator ``_health_note``,
    the gang slot watchdog) via the facade's transition hook, plus
    the membership plane's demoted/evicted/restored edges.  Thread-safe
    and allocation-light — the hook runs on engine scheduler threads.
    """

    def __init__(self, capacity: int = _HEALTH_EVENT_CAP):
        self.capacity = max(8, int(capacity))
        self._lock = threading.Lock()
        self._counters: Dict[tuple, int] = {}  # (peer, from, to) -> n
        self._events: List[dict] = []
        self.total = 0

    def note(self, peer, old: str, new: str) -> None:
        if old == new:
            return
        import time as _time

        with self._lock:
            key = (str(peer), str(old), str(new))
            self._counters[key] = self._counters.get(key, 0) + 1
            self.total += 1
            self._events.append({
                "peer": str(peer),
                "from": str(old),
                "to": str(new),
                "mono_ns": _time.perf_counter_ns(),
            })
            if len(self._events) > self.capacity:
                self._events.pop(0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "transitions_total": self.total,
                "counters": {
                    "|".join(k): v
                    for k, v in sorted(self._counters.items())
                },
                "events": [dict(e) for e in self._events],
            }


class SeqnLedger:
    """Receiver-side duplicate detection for eager segments.

    Sequence numbers are allocated monotonically per (communicator, peer)
    pair (``Communicator.next_outbound_seq``), so the receiving dataplane
    can discard any seqn it has already accepted — which makes both the
    ``duplicate`` fault and sender retransmits value-correct.  Memory is
    O(out-of-order window): a contiguous floor plus a small ahead-set.
    """

    def __init__(self):
        self._floor: Dict[tuple, int] = {}
        self._ahead: Dict[tuple, set] = {}

    def seen(self, key: tuple, seqn: int) -> bool:
        """Record ``seqn`` for ``key``; True when it was already recorded
        (i.e. this message is a duplicate)."""
        floor = self._floor.get(key, -1)
        if seqn <= floor:
            return True
        ahead = self._ahead.setdefault(key, set())
        if seqn in ahead:
            return True
        ahead.add(seqn)
        while floor + 1 in ahead:
            floor += 1
            ahead.discard(floor)
        self._floor[key] = floor
        return False

    def clear(self) -> None:
        self._floor.clear()
        self._ahead.clear()
