"""Epoch-versioned domain placement for the multi-node pool (counterpart of
``repro.pool.placement``; the same inputs give the same assignment, and
the JSON is the JAX package's, so either package reads the other's
POOL.json).

``PlacementMap`` is the versioned successor of the original frozen
``PoolTopology``: the *policy* half (ordered shard list, explicit pins, the
``undo-log`` -> ``embedding-mirror`` co-location alias, CRC32 hashing for
everything else) is unchanged, but on top of it rides an ordered tuple of
**placement epochs** — numbered, CRC-sealed move records appended by live
domain migration (``sharded.ShardedPool.migrate_domain``). Every domain-level route
consults the map: the newest epoch that names a domain wins, then explicit
pins, then the alias, then the hash. Placement is still deterministic — the
same (shards, pins, epochs) inputs always produce the same assignment — but
it is no longer *static*: a domain can move between nodes mid-life and every
subsequent open lands on the new node without re-hashing anything.

Durability: the map serialises into POOL.json (``to_json``/``from_json``).
Each epoch record carries its own CRC over a canonical payload, and records
must be contiguously numbered, so a torn or corrupt tail record degrades to
the longest valid epoch *prefix* — recovery falls back to the previous
epoch, never to a fresh hash. The flip itself (appending an epoch and
publishing the new map) is superblock-style: the writer builds the complete
new image beside the old one and swaps it in a single atomic publish
(``store.write_json_atomic``), so a crash mid-flip leaves exactly one side
visible.

``RebalancePolicy`` closes the loop: per-shard used/capacity gauges (the
capacity watermarks from ``PoolMetrics``) feed a high-watermark trigger that
proposes moving the largest *unpinned* alias-complete domain group off an
overfull shard onto the emptiest one — DisaggRec-style independent scaling
of memory nodes, with explicit pins treated as operator intent and never
auto-migrated.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Optional, Sequence, Union

from repro_torch.pool.device import PoolError


def _epoch_crc(epoch: int, moves: dict, reason: str) -> int:
    payload = json.dumps({"epoch": int(epoch), "reason": reason,
                          "moves": {k: int(v) for k, v in
                                    sorted(moves.items())}},
                         sort_keys=True)
    return zlib.crc32(payload.encode())


@dataclasses.dataclass(frozen=True)
class PlacementEpoch:
    """One numbered move record: ``moves`` maps domain -> new shard index.
    Records are append-only and contiguously numbered from 1; the CRC seals
    the record so a torn POOL.json tail is detected, not trusted."""

    epoch: int
    moves: dict
    reason: str = ""

    def to_json(self) -> dict:
        return {"epoch": int(self.epoch),
                "moves": {k: int(v) for k, v in self.moves.items()},
                "reason": self.reason,
                "crc": _epoch_crc(self.epoch, self.moves, self.reason)}

    @classmethod
    def from_json(cls, obj) -> Optional["PlacementEpoch"]:
        """Validated decode: ``None`` for anything torn or malformed."""
        try:
            epoch = int(obj["epoch"])
            moves = {str(k): int(v) for k, v in obj["moves"].items()}
            reason = str(obj.get("reason", ""))
            crc = int(obj["crc"])
        except (TypeError, KeyError, ValueError, AttributeError):
            return None
        if _epoch_crc(epoch, moves, reason) != crc:
            return None
        return cls(epoch=epoch, moves=moves, reason=reason)


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """Deterministic, epoch-versioned domain -> shard assignment.

    ``shards`` is the ordered tuple of node addresses (order is identity:
    shard i is always the i-th address — recovery reconnects by index).
    ``pin`` maps a domain name to an explicit shard index; ``epochs`` is the
    ordered move history. ``ALIAS`` makes co-location a property of the
    *policy*, not of luck: ``undo-log`` places wherever ``embedding-mirror``
    places unless pinned or moved apart explicitly.
    """

    shards: tuple = ()
    pin: dict = dataclasses.field(default_factory=dict)
    epochs: tuple = ()

    ALIAS = {"undo-log": "embedding-mirror"}

    @property
    def nshards(self) -> int:
        return len(self.shards)

    @property
    def epoch(self) -> int:
        """Current placement version (0 before any migration)."""
        return self.epochs[-1].epoch if self.epochs else 0

    def explicit(self, domain: str) -> Optional[int]:
        """Explicit assignment for `domain` (newest epoch wins, then the
        pin), or ``None`` when only the alias/hash would decide."""
        for rec in reversed(self.epochs):
            if domain in rec.moves:
                return int(rec.moves[domain])
        if domain in self.pin:
            return int(self.pin[domain])
        return None

    def place(self, domain: str) -> int:
        if self.nshards == 0:
            raise PoolError("empty placement: no shards")
        idx = self.explicit(domain)
        if idx is None:
            key = self.ALIAS.get(domain, domain)
            if key != domain:
                return self.place(key)       # follow the alias target fully
            idx = zlib.crc32(domain.encode()) % self.nshards
        if not 0 <= idx < self.nshards:
            raise PoolError(f"placement {domain!r} -> shard {idx} out of "
                            f"range (have {self.nshards} shards)")
        return idx

    def group(self, domain: str) -> list:
        """``domain`` plus every alias follower currently co-located with
        it — the set one epoch must move (or promote) together so the
        fused-op co-location invariant survives the flip. An explicitly
        separated follower (pinned or moved apart) is NOT in the group."""
        members = [domain]
        for follower, leader in self.ALIAS.items():
            if leader == domain and follower != domain \
                    and self.place(follower) == self.place(domain):
                members.append(follower)
        return members

    # -- evolution (both return NEW maps; the dataclass is frozen) -----------
    def with_epoch(self, moves: dict, reason: str = "") -> "PlacementMap":
        rec = PlacementEpoch(epoch=self.epoch + 1,
                             moves={k: int(v) for k, v in moves.items()},
                             reason=reason)
        return dataclasses.replace(self, epochs=self.epochs + (rec,))

    def with_pin(self, domain: str, idx: int) -> "PlacementMap":
        return dataclasses.replace(self, pin={**self.pin, domain: int(idx)})

    # -- (de)serialisation ---------------------------------------------------
    def to_json(self) -> dict:
        return {"shards": list(self.shards),
                "pin": {k: int(v) for k, v in self.pin.items()},
                "epochs": [rec.to_json() for rec in self.epochs]}

    @classmethod
    def from_json(cls, obj: dict) -> "PlacementMap":
        """Replay epoch records in order. The first torn, malformed, or
        out-of-sequence record ends the replay: placement falls back to the
        longest valid prefix (the previous epoch) — never to a re-hash of a
        domain an earlier epoch already moved."""
        epochs: list[PlacementEpoch] = []
        for raw in obj.get("epochs") or ():
            rec = PlacementEpoch.from_json(raw)
            if rec is None or rec.epoch != len(epochs) + 1:
                break
            epochs.append(rec)
        return cls(shards=tuple(obj.get("shards") or ()),
                   pin={k: int(v) for k, v in (obj.get("pin") or {}).items()},
                   epochs=tuple(epochs))

    @classmethod
    def parse(cls, shards: Union[str, Sequence[str]],
              placement: Union[str, dict, None] = None) -> "PlacementMap":
        """Build from CLI-ish inputs: ``shards`` is a list of addresses or
        one comma-separated string; ``placement`` is a dict or a
        ``dom=idx,dom=idx`` string of explicit pins."""
        if isinstance(shards, str):
            shards = [s.strip() for s in shards.split(",") if s.strip()]
        pin: dict = {}
        if isinstance(placement, dict):
            pin = {k: int(v) for k, v in placement.items()}
        elif placement:
            for part in placement.split(","):
                part = part.strip()
                if not part:
                    continue
                dom, _, idx = part.partition("=")
                if not idx.lstrip("-").isdigit():
                    raise PoolError(f"bad placement spec {part!r} "
                                    f"(want domain=shard_index)")
                pin[dom.strip()] = int(idx)
        return cls(shards=tuple(shards), pin=pin)


# The original name: a PlacementMap with no epochs IS the old static
# topology, so callers (and persisted POOL.json files) keep working.
PoolTopology = PlacementMap


@dataclasses.dataclass
class Migration:
    """One proposed move: lead domain plus its alias-complete group."""

    domain: str
    src: int
    dst: int
    group: tuple
    nbytes: int
    reason: str = ""


def _prev_homes(placement: PlacementMap, domain: str) -> set:
    """Every shard `domain` has lived on before its current one (from the
    epoch history) — the anti-churn memory. A group is never proposed back
    to any of them, so a domain too big for every node to stay under the
    watermark parks after at most nshards-1 hops instead of cycling
    A -> B -> C -> A re-copying itself forever. The memory rides in the
    persisted epochs, so it survives restarts."""
    homes = set()
    for k in range(len(placement.epochs) - 1, -1, -1):
        if domain in placement.epochs[k].moves:
            trimmed = dataclasses.replace(placement,
                                          epochs=placement.epochs[:k])
            homes.add(trimmed.place(domain))
    return homes


@dataclasses.dataclass
class RebalancePolicy:
    """High-watermark rebalancer over per-shard used/capacity gauges.

    When a shard's fill crosses ``high``, propose migrating its largest
    unpinned alias-complete domain group to the emptiest shard under the
    watermark. Hysteresis: a group is never proposed back to ANY shard it
    previously lived on (epoch history), so a dominant domain that keeps
    every node warm parks after a bounded number of hops instead of
    ping-ponging or cycling. (Emulated nodes grow on demand, so a move can
    never fail for capacity; tenant quotas surface as a typed writer
    failure the normal crash machinery recovers from.)
    """

    high: float = 0.75
    check_every: int = 8       # gauge-poll cadence in steps

    def due(self, step: int) -> bool:
        return self.check_every > 0 and step > 0 \
            and step % self.check_every == 0

    def propose(self, pool) -> list[Migration]:
        used, cap = {}, {}
        for i, snap in enumerate(pool.shard_metrics()):
            if snap.get("unreachable"):
                continue            # a dead node is not a migration target
            used[i] = int(snap.get("used_bytes") or 0)
            cap[i] = max(1, int(snap.get("capacity_bytes") or 1))
        if len(used) < 2:
            return []
        fill = {i: used[i] / cap[i] for i in used}
        hot = max(sorted(fill), key=lambda i: fill[i])
        if fill[hot] < self.high:
            return []
        placement = pool.placement
        candidates = []
        for lead, group, nbytes in pool.domain_groups(hot):
            if nbytes <= 0:
                continue
            if any(d in placement.pin for d in group):
                continue            # explicit pins are operator intent
            candidates.append((lead, group, nbytes))
        if not candidates:
            return []
        lead, group, nbytes = max(candidates, key=lambda c: (c[2], c[0]))
        prev = _prev_homes(placement, lead)
        best = None
        for i in sorted(fill):
            if i == hot or i in prev or fill[i] >= self.high:
                continue
            if best is None or fill[i] < fill[best]:
                best = i
        if best is None:
            return []
        return [Migration(
            domain=lead, src=hot, dst=best, group=group, nbytes=nbytes,
            reason=f"shard {hot} fill {fill[hot]:.2f} >= {self.high:.2f}; "
                   f"move {'+'.join(group)} ({nbytes}B) -> shard {best}")]
