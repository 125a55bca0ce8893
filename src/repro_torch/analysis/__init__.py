"""Correctness tooling for the port's pool stack (counterpart of
``repro.analysis``).

Two prongs, one package:

  * ``repro_torch.analysis.checker``: a runtime crash-consistency checker.
    ``CheckedPool`` wraps any ``PoolDevice`` backend and shadow-tracks every
    write/persist/crash/nmp per byte range, raising typed
    ``OrderingViolation`` errors the moment the persistence discipline is
    broken (unpersisted bytes read back after a crash, COMMIT persisted
    before its payload, a write landing inside a published A/B slot,
    use-after-free of a region's bytes). Enable with
    ``make_pool(..., check=True)`` or ``REPRO_POOL_CHECK=1``; off the
    default path otherwise.

  * ``repro_torch.analysis.lint``: the repo's static invariant lints over
    ``src/repro_torch`` (``python -m repro_torch.analysis.lint``):
    fault-point cross-referencing against the port's own drills,
    op-registry completeness, lock-order acyclicity, no socket I/O under a
    device lock, the v3 codecs and copies on the wire.

Neither imports torch.
"""
from repro_torch.analysis.checker import (CheckedPool, CommitBeforePayloadError,
                                          DoubleFreeError, OrderingViolation,
                                          RegionOverlapError, ShadowTracker,
                                          UnpersistedReadError,
                                          UseAfterFreeError,
                                          WriteAfterPublishError,
                                          checking_enabled)
from repro_torch.analysis.points import POINT_ROLES, Role

__all__ = [
    "CheckedPool", "ShadowTracker", "OrderingViolation",
    "UnpersistedReadError", "CommitBeforePayloadError",
    "WriteAfterPublishError", "UseAfterFreeError", "DoubleFreeError",
    "RegionOverlapError", "checking_enabled", "POINT_ROLES", "Role",
]
