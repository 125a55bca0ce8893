"""The persist/fault-point catalog (counterpart of
``repro.analysis.points``): one registry, two consumers.

Every named barrier in ``src/repro_torch`` is classified here by its *role*
in the persistence protocol. The runtime checker
(``repro_torch.analysis.checker``) keys its ordering rules on the role: a
``COMMIT`` persist must find its payload already clean, a ``PUBLISH``
persist seals the A/B slot it just elected. The static linter
(``repro_torch.analysis.lint``) keeps the catalog and the tree in step: a
persist-point literal in ``src/repro_torch`` that this registry does not
classify is a lint error, as is a registry entry that no test, example or
soak schedule of the port ever arms (a dead fault point is a crash window
nothing drills). The names are the JAX package's, so a drill fires at the
same place in both packages.

Roles:

  * ``PAYLOAD`` — a plain data barrier: flush these bytes, no ordering
    obligation beyond itself.
  * ``COMMIT`` — the second of the paper's two barriers: persisting it
    declares the *payload* durable, so any still-dirty byte in the
    enclosing region at this moment is an ordering violation.
  * ``PUBLISH`` — an A/B single-publish election (superblock slot,
    JsonRegion half, manifest advance): the persisted slot is now the
    recovery-elected image and must not be written in place until the
    sibling slot is published over it.
  * ``WINDOW`` — a control-flow crash window (no bytes flushed): migration
    and replication phases a drill can crash inside.
  * ``CONTROL`` — a pipeline-stage fault point hit by the manager/nmp
    layer between barriers (no persist of its own).
  * ``GENERIC`` — the API-default ``point="persist"``; callers that care
    about a barrier name one. Exempt from the dead-point rule.
"""
from __future__ import annotations

from enum import Enum


class Role(str, Enum):
    PAYLOAD = "payload"
    COMMIT = "commit"
    PUBLISH = "publish"
    WINDOW = "window"
    CONTROL = "control"
    GENERIC = "generic"


POINT_ROLES: dict[str, Role] = {
    # generic default (Region.persist / device.persist with no name)
    "persist": Role.GENERIC,
    # superblock directory publishes (allocator A/B slots); the point name
    # carries the *reason* for the directory update, the mechanism is the
    # same single-publish election every time
    "superblock": Role.PUBLISH,
    "undo-grow-alloc": Role.PUBLISH,
    "undo-grow-free": Role.PUBLISH,
    "migrate-alloc": Role.PUBLISH,
    "migrate-gc": Role.PUBLISH,
    "migrate-sweep": Role.PUBLISH,
    "replica-alloc": Role.PUBLISH,
    "replica-gc": Role.PUBLISH,
    "promote-alloc": Role.PUBLISH,
    "promote-gc": Role.PUBLISH,
    # JsonRegion A/B publishes (manifest + friends)
    "manifest": Role.PUBLISH,
    "manifest-init": Role.PUBLISH,
    "manifest-advance": Role.PUBLISH,
    "manifest-dense": Role.PUBLISH,
    "undo-meta": Role.PUBLISH,
    "replica-watermark": Role.PUBLISH,
    "manifest-witness": Role.PUBLISH,
    # the paper's two-barrier undo protocol
    "undo-payload": Role.PAYLOAD,
    "undo-commit": Role.COMMIT,
    # plain data barriers
    "mirror-load": Role.PAYLOAD,
    "mirror-apply": Role.PAYLOAD,
    "rollback": Role.PAYLOAD,
    "undo-gc": Role.PAYLOAD,
    "undo-grow-scrub": Role.PAYLOAD,
    "dense-blob": Role.PAYLOAD,
    "migrate-import": Role.PAYLOAD,
    "replica-import": Role.PAYLOAD,
    "promote-import": Role.PAYLOAD,
    # migration / replication crash windows (sharded._hit)
    "migrate.pre-copy": Role.WINDOW,
    "migrate.mid-copy": Role.WINDOW,
    "migrate.post-copy-pre-flip": Role.WINDOW,
    "migrate.post-flip-pre-gc": Role.WINDOW,
    "replica.pre-copy": Role.WINDOW,
    "replica.mid-copy": Role.WINDOW,
    "replica.post-copy": Role.WINDOW,
    "replica.commit-ship": Role.WINDOW,
    "promote.pre-copy": Role.WINDOW,
    "promote.mid-copy": Role.WINDOW,
    "promote.post-copy-pre-flip": Role.WINDOW,
    "promote.post-flip": Role.WINDOW,
    # manager/nmp pipeline-stage fault points
    "tier_e.between-commit-and-apply": Role.CONTROL,
    "tier_e.between-apply-and-manifest": Role.CONTROL,
}

# Points exempt from the linter's dead-point rule (defined in src but not
# required to be armed by any test/example schedule), each with a reason.
UNARMED_OK: dict[str, str] = {
    "persist": "API default; every named barrier overrides it",
}
