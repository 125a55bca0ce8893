"""Repo-specific static invariant lints for the port's pool stack
(counterpart of ``repro.analysis.lint``; the same rules).

``python -m repro_torch.analysis.lint [paths...]``: an AST pass over
``src/repro_torch`` that enforces the invariants code review keeps missing.
Its fault points are cross-referenced against the port's own drills only:
``tests/test_torch_*.py`` and ``src/repro_torch/examples/``. The JAX
package's tests arm the same point names, and reading them would hide a
point that the port never drills.

  * **R1 fault-point cross-reference** —
    R1a: a point a test/example *arms* (``crash_at``/``torn_at``/
    ``drop_at``/``seeded``/``*POINTS``/``*WINDOWS`` schedules) must exist
    at a ``faults.hit(...)``/``persist(point=...)`` site in src, else the
    drill is a typo that silently never fires.
    R1b: the reverse — a fault point defined in src that no test, example
    or soak schedule ever exercises is a dead crash window nothing drills.
    R1c: every persist/fault-point literal in src must be classified in
    ``repro_torch.analysis.points.POINT_ROLES`` (the runtime checker keys
    its ordering rules on the role).
  * **R2 op-registry completeness** — every op in ``protocol.OPS`` needs a
    client stub (an ``{"op": <name>}`` frame literal), a server dispatch
    arm (``PoolServer._op_<name>`` or inline), and vice versa: stubs/arms
    for unknown ops are drift. Every ``NMP_OPS`` kind needs its client
    dispatch literal in ``nmp.py``; every ``device.nmp("<kind>")`` call
    site must name a registered kind. Wire-visible error classes whose
    ``__init__`` takes extra required args need a ``register_error`` codec
    (the default by-name re-raise would ``TypeError``).
  * **R3 lock-order acyclicity** — ``threading.Lock``/``RLock`` attributes
    acquired via ``with self.<lock>`` across the pool/serve modules must
    form an acyclic order graph (one level of same-class call propagation
    is followed); cycles are reported with both acquisition paths.
  * **R4 no socket I/O under a device lock** — no blocking socket call
    (``send_frame``/``recv_frame``/``sendall``/``sendmsg``/``recv``/
    ``accept``/``connect``) while holding a ``_lock`` device lock (the
    PoolServer pattern): a slow peer must never stall every other
    tenant's media ops.
  * **R5 v3-codec completeness** — every data-class op the wire declares
    binary (``read``/``write`` plus the ``_V3_NMP_KINDS`` tuple) has a
    ``V3_CODECS`` entry with a callable pack/unpack pair, every codec
    names a registered op or nmp kind, opcodes are collision-free, and
    each request codec is reachable from ``_V3_BY_CODE``.
  * **R6 no bytes() on the data path** — in ``pool/{protocol,remote,
    server}.py`` any ``bytes(...)``/``.tobytes()``/``b"".join(...)``
    call must carry a ``# wire-copy:`` annotation (same line or the one
    above) naming why the copy is sanctioned; unannotated copies are how
    zero-copy regresses one innocent-looking call at a time.

Exit status 0 when clean; 1 with ``file:line: [rule] message`` diagnostics
otherwise. Passing explicit ``.py`` files runs the file-local rules only
(R1c/R1a against the registry, R3, R4) — that is how the seeded bad
fixture in ``tests/fixtures/`` is linted without polluting the project
pass.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
from dataclasses import dataclass, field

# ops handled inline by the server dispatch loop (connection lifecycle +
# scatter-gather replay), not via a _op_<name> method
INLINE_SERVER_OPS = frozenset({"hello", "ping", "close", "batch"})

# blocking socket surface (raw socket + framing helpers)
SOCKET_CALLS = frozenset({"sendall", "send", "sendmsg", "sendmsg_all",
                          "recv", "recv_into", "accept", "connect",
                          "send_frame", "recv_frame", "recv_frame_pooled"})

# the zero-copy wire data path: files where R6 polices byte materialization
DATA_PATH_FILES = ("pool/protocol.py", "pool/remote.py", "pool/server.py")

# schedule constructors whose literal args arm a fault point. ``seeded`` is
# absent on purpose: its real call sites take a *POINTS constant (covered by
# the tuple-assignment rule); bare literals in seeded() are the schedule
# API's own determinism tests, not drills.
ARMING_CALLS = frozenset({"crash_at", "torn_at", "drop_at"})

# the tree project mode lints when given no path
DEFAULT_ROOT = "src/repro_torch"

# keyword names whose string value names a persist/fault point
POINT_KWARGS = ("point", "apply_point")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    msg: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


@dataclass
class FileFacts:
    """Everything one source file contributes to the cross-file rules."""
    path: str
    fired: list = field(default_factory=list)      # (point, line) hit/persist sites
    call_strs: list = field(default_factory=list)  # (str, line) positional call args
    armed: list = field(default_factory=list)      # (point, line) schedule sites
    strings: set = field(default_factory=set)      # every str constant
    op_literals: list = field(default_factory=list)    # ({"op": X}, line)
    nmp_calls: list = field(default_factory=list)      # (.nmp("kind"), line)
    server_arms: list = field(default_factory=list)    # (_op_name, line)
    classes: dict = field(default_factory=dict)        # name -> [base names]
    error_inits: dict = field(default_factory=dict)    # name -> (required, line)
    registered_errors: set = field(default_factory=set)
    lock_edges: list = field(default_factory=list)     # ((cls,a),(cls,b),site)
    lock_attrs: set = field(default_factory=set)       # (cls, attr)
    socket_under_lock: list = field(default_factory=list)  # (line, call, lock)


def _base_name(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _const_str(node):
    return node.value if isinstance(node, ast.Constant) \
        and isinstance(node.value, str) else None


def _const_strs(node) -> list:
    """String constants of a node, looking through conditional expressions
    (``point="a" if gen else "b"``)."""
    if isinstance(node, ast.IfExp):
        return _const_strs(node.body) + _const_strs(node.orelse)
    s = _const_str(node)
    return [s] if s is not None else []


def _tuple_strs(node):
    if isinstance(node, (ast.Tuple, ast.List)):
        out = [_const_str(e) for e in node.elts]
        return [(s, e.lineno) for s, e in zip(out, node.elts, strict=True)
                if s is not None]
    return []


class _FileVisitor(ast.NodeVisitor):
    """Single pass collecting every fact the rules need."""

    def __init__(self, facts: FileFacts):
        self.f = facts
        self._class: list[str] = []

    # -- strings / points ------------------------------------------------------
    def visit_Constant(self, node):
        if isinstance(node.value, str):
            self.f.strings.add(node.value)

    def visit_Dict(self, node):
        for k, v in zip(node.keys, node.values, strict=True):
            if _const_str(k) == "op":
                name = _const_str(v)
                if name is not None:
                    self.f.op_literals.append((name, node.lineno))
        self.generic_visit(node)

    def visit_Assign(self, node):
        # SOAK_POINTS / POINTS / *_WINDOWS tuples are arming schedules
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and \
                    (tgt.id.endswith("POINTS") or tgt.id.endswith("WINDOWS")):
                self.f.armed.extend(_tuple_strs(node.value))
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        # fired: faults.hit("x") / self._hit("x") / nmp kind dispatch
        if name in ("hit", "_hit") and node.args:
            s = _const_str(node.args[0])
            if s is not None:
                self.f.fired.append((s, node.lineno))
        if name == "nmp" and node.args:
            s = _const_str(node.args[0])
            if s is not None:
                self.f.nmp_calls.append((s, node.lineno))
        if name in ARMING_CALLS:
            for arg in node.args:
                s = _const_str(arg)
                if s is not None:
                    self.f.armed.append((s, node.lineno))
                self.f.armed.extend(_tuple_strs(arg))
            for kw in node.keywords:
                self.f.armed.extend(_tuple_strs(kw.value))
        if name == "register_error" and node.args:
            s = _const_str(node.args[0])
            if s is not None:
                self.f.registered_errors.add(s)
        # fired: any point=/apply_point= literal keyword
        for kw in node.keywords:
            if kw.arg in POINT_KWARGS:
                for s in _const_strs(kw.value):
                    self.f.fired.append((s, node.lineno))
        # points also travel positionally (free_domain(d, "migrate-gc"),
        # alloc_region(..., "migrate-alloc")): any registered point name
        # appearing as a positional call arg is a loose fire site
        for arg in node.args:
            s = _const_str(arg)
            if s is not None:
                self.f.call_strs.append((s, node.lineno))
        self.generic_visit(node)

    # -- classes / defs --------------------------------------------------------
    def visit_ClassDef(self, node):
        self.f.classes[node.name] = [_base_name(b) for b in node.bases]
        self._class.append(node.name)
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                if item.name == "__init__":
                    a = item.args
                    required = len(a.args) - 1 - len(a.defaults)
                    self.f.error_inits[node.name] = (required, item.lineno)
                if item.name.startswith("_op_"):
                    self.f.server_arms.append((item.name[4:], item.lineno))
        self._scan_locks(node)
        self.generic_visit(node)
        self._class.pop()

    def visit_FunctionDef(self, node):
        # point="..." defaults on signatures are fire sites too
        a = node.args
        for arg, default in zip(a.args[len(a.args) - len(a.defaults):],
                                a.defaults, strict=True):
            if arg.arg in POINT_KWARGS or arg.arg.endswith("_point"):
                s = _const_str(default)
                if s is not None:
                    self.f.fired.append((s, node.lineno))
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- R3/R4: locks ----------------------------------------------------------
    def _scan_locks(self, cls: ast.ClassDef):
        cname = cls.name
        locks: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _base_name(node.value.func) in ("Lock", "RLock"):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        locks.add(tgt.attr)
                        self.f.lock_attrs.add((cname, tgt.attr))
        if not locks:
            return

        # method -> [(lock, line)] acquired directly; and per-method walk
        # recording edges + self-call sites while locks are held
        direct: dict[str, list] = {}
        pending: list = []   # (held_tuple, callee, line, method)

        def walk(stmts, held, method):
            for node in stmts:
                if isinstance(node, ast.With):
                    acquired = []
                    for item in node.items:
                        ctx = item.context_expr
                        if isinstance(ctx, ast.Attribute) and \
                                isinstance(ctx.value, ast.Name) and \
                                ctx.value.id == "self" and ctx.attr in locks:
                            for h in held:
                                self.f.lock_edges.append((
                                    (cname, h), (cname, ctx.attr),
                                    (self.f.path, node.lineno,
                                     f"{cname}.{method}")))
                            acquired.append(ctx.attr)
                            direct.setdefault(method, []).append(
                                (ctx.attr, node.lineno))
                    walk(node.body, held + acquired, method)
                    continue
                # record socket calls + self-calls under held locks
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    callee = sub.func
                    cal = callee.attr if isinstance(callee, ast.Attribute) \
                        else (callee.id if isinstance(callee, ast.Name)
                              else "")
                    if held and cal in SOCKET_CALLS and "_lock" in held:
                        self.f.socket_under_lock.append(
                            (sub.lineno, cal, f"{cname}._lock"))
                    if held and isinstance(callee, ast.Attribute) and \
                            isinstance(callee.value, ast.Name) and \
                            callee.value.id == "self":
                        pending.append((tuple(held), callee.attr,
                                        sub.lineno, method))
                # recurse into nested statement bodies
                for fld in ("body", "orelse", "finalbody", "handlers"):
                    sub_stmts = getattr(node, fld, None)
                    if sub_stmts:
                        if fld == "handlers":
                            for h in sub_stmts:
                                walk(h.body, held, method)
                        else:
                            walk(sub_stmts, held, method)

        for item in cls.body:
            if isinstance(item, ast.FunctionDef):
                walk(item.body, [], item.name)

        # one level of same-class call propagation: with self.A: self.f()
        # where f acquires B directly => edge A -> B
        for held, callee, line, method in pending:
            for lk, dline in direct.get(callee, []):
                for h in held:
                    if h != lk:
                        self.f.lock_edges.append((
                            (cname, h), (cname, lk),
                            (self.f.path, line,
                             f"{cname}.{method} -> self.{callee}() "
                             f"acquires {lk} at line {dline}")))


def collect(path: str) -> FileFacts:
    facts = FileFacts(path=path)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError) as e:
        raise SystemExit(f"{path}: cannot lint: {e}") from e
    _FileVisitor(facts).visit(tree)
    return facts


def _drill_files(src_root: str) -> list[str]:
    """The port's drills: ``tests/test_torch_*.py`` of the checkout around
    ``src_root`` and the examples under it (never ``tests/fixtures/``)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(src_root)))
    tests = os.path.join(repo, "tests")
    out = sorted(os.path.join(tests, f) for f in (
        os.listdir(tests) if os.path.isdir(tests) else ())
        if f.startswith("test_torch_") and f.endswith(".py"))
    examples = os.path.join(src_root, "examples")
    return out + (_py_files(examples) if os.path.isdir(examples) else [])


def _py_files(root: str) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                   if f.endswith(".py"))
    return out


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------
def _rule_points(src_facts, aux_facts, findings: list):
    """R1a/R1b/R1c over the whole tree."""
    from repro_torch.analysis.points import POINT_ROLES, UNARMED_OK
    declared = set(POINT_ROLES)
    fired: dict[str, tuple] = {}
    loose_fired: dict[str, tuple] = {}
    for f in src_facts:
        if os.sep + "analysis" + os.sep in f.path:
            continue      # the registry/checker mention every point
        for name, line in f.fired:
            fired.setdefault(name, (f.path, line))
        for name, line in f.call_strs:
            if name in declared:       # positional point args
                loose_fired.setdefault(name, (f.path, line))
    all_fired = {**loose_fired, **fired}
    armed_sites: list = []
    mentioned: set = set()
    for f in src_facts + aux_facts:
        # a point armed in the same file it persists with is a test's own
        # ad-hoc barrier, not a typo
        local = {name for name, _ in f.fired}
        armed_sites.extend((name, f.path, line, local)
                           for name, line in f.armed)
    for f in aux_facts:
        mentioned |= f.strings
    mentioned |= {name for name, _p, _l, _loc in armed_sites}

    # R1a: armed point with no fire site = typo, the drill never triggers
    for name, path, line, local in armed_sites:
        if name not in all_fired and name not in local:
            findings.append(Finding(
                "R1a-typo-arm", path, line,
                f"fault schedule arms point {name!r} but no "
                f"faults.hit()/persist(point=...) site in src/repro_torch can "
                f"ever fire it"))
    # R1c: fired point missing from the role registry
    for name, (path, line) in sorted(fired.items()):
        if name not in declared:
            findings.append(Finding(
                "R1c-unregistered-point", path, line,
                f"persist/fault point {name!r} is not classified in "
                f"repro_torch.analysis.points.POINT_ROLES — the runtime checker "
                f"cannot apply its ordering rule"))
    # R1b: dead point — defined in src, exercised nowhere
    for name, (path, line) in sorted(all_fired.items()):
        if name not in mentioned and name not in UNARMED_OK:
            findings.append(Finding(
                "R1b-dead-point", path, line,
                f"fault point {name!r} is never armed by any test, example "
                f"or soak schedule — a crash window nothing drills"))
    for name in sorted(declared - set(all_fired) - set(UNARMED_OK)):
        findings.append(Finding(
            "R1b-dead-point", "src/repro_torch/analysis/points.py", 1,
            f"POINT_ROLES classifies {name!r} but no src site fires it"))


def _rule_ops(src_facts, findings: list):
    """R2: OPS/NMP_OPS <-> client stubs <-> server arms <-> error codecs."""
    from repro_torch.pool.protocol import NMP_OPS, OPS
    stubs: dict[str, tuple] = {}
    arms: dict[str, tuple] = {}
    nmp_sites: dict[str, tuple] = {}
    nmp_literals: set = set()
    registered: set = set()
    server_path = None
    for f in src_facts:
        for name, line in f.op_literals:
            stubs.setdefault(name, (f.path, line))
        for name, line in f.nmp_calls:
            nmp_sites.setdefault(name, (f.path, line))
        if f.path.endswith("server.py"):
            server_path = f.path
            for name, line in f.server_arms:
                arms.setdefault(name.replace("_", "-"), (f.path, line))
                arms.setdefault(name, (f.path, line))
        if f.path.endswith("nmp.py"):
            nmp_literals |= f.strings
        registered |= f.registered_errors

    for op in sorted(OPS):
        if op not in stubs and op not in INLINE_SERVER_OPS:
            findings.append(Finding(
                "R2a-missing-client-stub", "src/repro_torch/pool/protocol.py", 1,
                f"op {op!r} is in protocol.OPS but no client builds an "
                f'{{"op": {op!r}}} frame — unreachable server surface'))
        if op not in arms and op not in INLINE_SERVER_OPS:
            findings.append(Finding(
                "R2b-missing-server-arm", server_path or "server.py", 1,
                f"op {op!r} is in protocol.OPS but PoolServer has no "
                f"_op_{op.replace('-', '_')} method"))
    for name, (path, line) in sorted(stubs.items()):
        if name not in OPS:
            findings.append(Finding(
                "R2c-unknown-op", path, line,
                f'client frame literal {{"op": {name!r}}} names an op '
                f"missing from protocol.OPS"))
    for name, (path, line) in sorted(arms.items()):
        if name.replace("_", "-") not in OPS and name not in OPS:
            findings.append(Finding(
                "R2c-unknown-op", path, line,
                f"server arm _op_{name} has no matching entry in "
                f"protocol.OPS"))
    for kind in sorted(NMP_OPS):
        if kind not in nmp_literals:
            findings.append(Finding(
                "R2d-missing-nmp-dispatch", "src/repro_torch/pool/nmp.py", 1,
                f"nmp kind {kind!r} is in protocol.NMP_OPS but nmp.py "
                f"never dispatches it"))
    for kind, (path, line) in sorted(nmp_sites.items()):
        if kind not in NMP_OPS:
            findings.append(Finding(
                "R2d-unknown-nmp-kind", path, line,
                f"device.nmp({kind!r}) names a kind missing from "
                f"protocol.NMP_OPS"))

    # wire-visible error classes needing a codec: descendants of PoolError /
    # InjectedCrash whose __init__ has >1 required arg
    classes: dict[str, list] = {}
    locs: dict[str, str] = {}
    for f in src_facts:
        for cname, bases in f.classes.items():
            classes.setdefault(cname, bases)
            locs.setdefault(cname, f.path)
    wire_roots = {"PoolError", "InjectedCrash"}
    wire: set = set()
    changed = True
    while changed:
        changed = False
        for cname, bases in classes.items():
            if cname not in wire and \
                    any(b in wire_roots or b in wire for b in bases):
                wire.add(cname)
                changed = True
    for f in src_facts:
        for cname, (required, line) in f.error_inits.items():
            if cname in (wire | wire_roots) and required > 1 and \
                    cname not in registered:
                findings.append(Finding(
                    "R2e-unregistered-error", f.path, line,
                    f"wire-visible error {cname} needs {required} "
                    f"constructor args but has no register_error codec — "
                    f"the by-name re-raise on the client would TypeError"))


def _rule_v3(findings: list):
    """R5: the binary-header registry is complete and closed."""
    from repro_torch.pool import protocol as P
    path = "src/repro_torch/pool/protocol.py"
    declared = ("read", "write") + tuple(P._V3_NMP_KINDS)
    for name in declared:
        codec = P.V3_CODECS.get(name)
        if codec is None:
            findings.append(Finding(
                "R5a-missing-v3-codec", path, 1,
                f"data op {name!r} is declared binary on the v3 wire but "
                f"V3_CODECS has no entry — it silently rides as JSON"))
        elif not (callable(codec.pack) and callable(codec.unpack)):
            findings.append(Finding(
                "R5a-missing-v3-codec", path, 1,
                f"V3_CODECS[{name!r}] is missing a callable pack/unpack "
                f"pair"))
    codes: dict[int, str] = {}
    for name, codec in sorted(P.V3_CODECS.items()):
        if name not in P.OPS and name not in P.NMP_OPS:
            findings.append(Finding(
                "R5b-unknown-v3-op", path, 1,
                f"V3_CODECS[{name!r}] names neither a protocol.OPS op nor "
                f"an NMP_OPS kind"))
        other = codes.setdefault(codec.code, name)
        if other != name:
            findings.append(Finding(
                "R5c-opcode-collision", path, 1,
                f"binary opcode {codec.code} is claimed by both "
                f"{other!r} and {name!r}"))
        if P._V3_BY_CODE.get(codec.code) is not codec:
            findings.append(Finding(
                "R5d-unreachable-codec", path, 1,
                f"V3_CODECS[{name!r}] (code {codec.code}) is not what "
                f"_V3_BY_CODE decodes — requests would unpack as the "
                f"wrong op"))


def _rule_copies(paths, findings: list):
    """R6: unannotated byte materialization on the wire data path."""
    for path in paths:
        norm = path.replace(os.sep, "/")
        if not any(norm.endswith(rel) for rel in DATA_PATH_FILES):
            continue
        with open(path, "r", encoding="utf-8") as fh:
            src = fh.read()
        lines = src.splitlines()
        for node in ast.walk(ast.parse(src, filename=path)):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "bytes":
                what = "bytes()"
            elif isinstance(fn, ast.Attribute) and fn.attr == "tobytes":
                what = ".tobytes()"
            elif isinstance(fn, ast.Attribute) and fn.attr == "join" and \
                    isinstance(fn.value, ast.Constant) and \
                    isinstance(fn.value.value, bytes):
                what = 'b"".join()'
            else:
                continue
            window = lines[max(0, node.lineno - 2):node.lineno]
            if any("wire-copy:" in ln for ln in window):
                continue
            findings.append(Finding(
                "R6-copy-on-data-path", path, node.lineno,
                f"{what} on the wire data path without a '# wire-copy:' "
                f"annotation — bodies travel as memoryview/np.frombuffer "
                f"views; annotate the line if this copy is sanctioned"))


def _rule_locks(facts_list, findings: list):
    """R3: the lock-order graph must be acyclic; R4: no socket I/O under a
    device lock."""
    edges: dict = {}
    for f in facts_list:
        for a, b, site in f.lock_edges:
            edges.setdefault((a, b), site)
        for line, call, lock in f.socket_under_lock:
            findings.append(Finding(
                "R4-socket-under-lock", f.path, line,
                f"blocking socket call {call}() while holding {lock} — a "
                f"slow peer stalls every op behind the device lock"))

    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    # DFS cycle detection, reporting each cycle once with both paths
    seen_cycles = set()
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in
             set(graph) | {b for bs in graph.values() for b in bs}}
    stack: list = []

    def dfs(n):
        color[n] = GREY
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            if color[m] == GREY:
                cyc = tuple(stack[stack.index(m):]) + (m,)
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    hops = []
                    for x, y in zip(cyc, cyc[1:], strict=False):
                        path, line, where = edges[(x, y)]
                        hops.append(f"{x[0]}.{x[1]} -> {y[0]}.{y[1]} "
                                    f"({where}, {path}:{line})")
                    path0, line0, _ = edges[(cyc[0], cyc[1])]
                    findings.append(Finding(
                        "R3-lock-cycle", path0, line0,
                        "lock-order cycle: " + "; ".join(hops)))
            elif color[m] == WHITE:
                dfs(m)
        stack.pop()
        color[n] = BLACK

    for n in sorted(color):
        if color[n] == WHITE:
            dfs(n)


def _rule_points_local(facts: FileFacts, findings: list):
    """File-local R1: registry sync for fired points, typo check for armed
    points (against the registry, since the src tree is not in scope)."""
    from repro_torch.analysis.points import POINT_ROLES
    declared = set(POINT_ROLES)
    local_fired = {name for name, _ in facts.fired}
    for name, line in facts.fired:
        if name not in declared:
            findings.append(Finding(
                "R1c-unregistered-point", facts.path, line,
                f"persist/fault point {name!r} is not classified in "
                f"repro_torch.analysis.points.POINT_ROLES"))
    for name, line in facts.armed:
        if name not in declared and name not in local_fired:
            findings.append(Finding(
                "R1a-typo-arm", facts.path, line,
                f"fault schedule arms point {name!r} but nothing can "
                f"ever fire it"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def run(paths: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    file_args = [p for p in paths if os.path.isfile(p)]
    dir_args = [p for p in paths if os.path.isdir(p)]
    for p in paths:
        if not os.path.exists(p):
            raise SystemExit(f"lint: no such path: {p}")

    if file_args and not dir_args:
        # file-local mode (the bad-fixture path)
        for p in file_args:
            facts = collect(p)
            _rule_points_local(facts, findings)
            _rule_locks([facts], findings)
            for name, line in facts.nmp_calls:
                from repro_torch.pool.protocol import NMP_OPS
                if name not in NMP_OPS:
                    findings.append(Finding(
                        "R2d-unknown-nmp-kind", p, line,
                        f"device.nmp({name!r}) names a kind missing from "
                        f"protocol.NMP_OPS"))
        return findings

    # project mode: src tree + the port's drills for cross-referencing
    src_root = dir_args[0] if dir_args else DEFAULT_ROOT
    src_facts = [collect(p) for p in _py_files(src_root)]
    aux_facts = [collect(p) for p in _drill_files(src_root)]
    _rule_points(src_facts, aux_facts, findings)
    _rule_ops(src_facts, findings)
    _rule_locks(src_facts, findings)
    _rule_v3(findings)
    _rule_copies([f.path for f in src_facts], findings)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific invariant lints for the pool stack")
    ap.add_argument("paths", nargs="*", default=[DEFAULT_ROOT],
                    help="src tree (project mode) or .py files "
                         f"(file-local mode); default {DEFAULT_ROOT}")
    args = ap.parse_args(argv)
    findings = run(args.paths or [DEFAULT_ROOT])
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        print(f)
    if findings:
        print(f"lint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"lint: clean ({len(_py_files(args.paths[0]))} files)"
          if args.paths and os.path.isdir(args.paths[0])
          else "lint: clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
