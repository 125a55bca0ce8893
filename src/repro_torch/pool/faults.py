"""Deterministic fault injection for the emulated pool (counterpart of
``repro.pool.faults``; the point names are the same strings, so a drill
written for either package fires at the same place in both).

A ``FaultSchedule`` is a list of events, each armed at the *n*-th occurrence
of a named instrumentation point. Points are emitted by the device layer
(every ``persist`` names its barrier: ``undo-payload``, ``undo-commit``,
``mirror-apply``, ``manifest-advance``, ``superblock`` ...) and by the
checkpoint manager between pipeline stages (``tier_e.between-commit-and-apply``).

Event kinds:
  * ``crash`` — raise ``InjectedCrash`` at the point (phase ``before`` skips
    the barrier entirely, ``after`` runs it first — a crash right after a
    successful COMMIT).
  * ``torn``  — the persist copies only the first half of its first dirty
    range to media, then crashes: the classic torn write.
  * ``drop``  — the persist is silently skipped (a missing ``clwb``/fence);
    execution continues, the data is simply not durable.

Schedules are deterministic by construction: occurrences are counted, not
sampled, so a test replays bit-identically. ``seeded(seed, points, every)``
builds a reproducible pseudo-random schedule for soak drills, the same
schedule as the JAX package's for the same seed.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field


class InjectedCrash(RuntimeError):
    """Simulated power loss / SIGKILL at an instrumentation point."""

    def __init__(self, point: str, occurrence: int):
        super().__init__(f"injected crash at '{point}' (occurrence "
                         f"{occurrence})")
        self.point = point
        self.occurrence = occurrence


@dataclass(frozen=True)
class FaultEvent:
    kind: str                 # "crash" | "torn" | "drop"
    point: str                # instrumentation point name
    occurrence: int = 1       # fire at the n-th hit of `point` (1-based)
    phase: str = "before"     # crash only: "before" | "after" the barrier


@dataclass
class FaultSchedule:
    events: tuple = ()
    counts: dict = field(default_factory=dict)   # point -> hits so far
    fired: list = field(default_factory=list)    # (event, hit#) audit trail

    # -- constructors --------------------------------------------------------
    @classmethod
    def crash_at(cls, point: str, occurrence: int = 1,
                 phase: str = "before") -> "FaultSchedule":
        return cls(events=(FaultEvent("crash", point, occurrence, phase),))

    @classmethod
    def torn_at(cls, point: str, occurrence: int = 1) -> "FaultSchedule":
        return cls(events=(FaultEvent("torn", point, occurrence),))

    @classmethod
    def drop_at(cls, point: str, occurrence: int = 1) -> "FaultSchedule":
        return cls(events=(FaultEvent("drop", point, occurrence),))

    @classmethod
    def seeded(cls, seed: int, points: tuple, every: int = 7,
               kind: str = "drop") -> "FaultSchedule":
        """Reproducible pseudo-random schedule: for each point, fire `kind`
        at occurrence h(seed, point) % every + 1 (no RNG state, pure hash)."""
        evs = []
        for p in points:
            h = zlib.crc32(f"{seed}:{p}".encode())
            evs.append(FaultEvent(kind, p, h % every + 1))
        return cls(events=tuple(evs))

    # -- runtime -------------------------------------------------------------
    def hit(self, point: str) -> str:
        """Count an occurrence of `point`; return the action the caller must
        take: "ok" | "drop" | "torn" | "crash-after". Raises InjectedCrash
        for a phase="before" crash."""
        n = self.counts.get(point, 0) + 1
        self.counts[point] = n
        for ev in self.events:
            if ev.point == point and ev.occurrence == n:
                self.fired.append((ev, n))
                if ev.kind == "crash":
                    if ev.phase == "before":
                        raise InjectedCrash(point, n)
                    return "crash-after"
                return ev.kind
        return "ok"
