"""Lifecycle self-analysis: resource-leak, bracket-discipline, and
shutdown-completeness passes over the port's own source (self-lint
passes 8–10; a copy of ``nbdistributed_tpu/analysis/lifecycle.py``).

The review history after the gateway arc shows the dominant bug class
is no longer data races (the :mod:`concur` lockset passes own those) but
*lifecycle* bugs: fds and reader threads leaked on failed hellos,
unreaped children on signal paths, and paired counters released on
only some exception edges.  This module mechanizes that class with
the same interprocedural machinery as :mod:`concur` — one-level call
resolution, constructor-typed attributes, the ``*_locked``-style
conventions, per-site exemption tables — aimed at acquire/release
pairs instead of locksets:

1. **resource-leak** (:func:`check_resource_leaks`): a declared
   acquire vocabulary (``socket.socket`` / ``create_connection`` /
   ``socketpair``, write-mode ``open``, non-daemon
   ``threading.Thread``, ``subprocess.Popen``,
   ``tempfile.TemporaryDirectory``, ``mmap.mmap``,
   ``ThreadingHTTPServer``) bound to a FUNCTION-LOCAL name must reach
   its release (``close``/``join``/``wait``/``cleanup``/
   ``shutdown``…) on **all** paths including exception edges.  A
   ``with`` block or a release inside a ``finally`` satisfies it;
   ownership transfer is modeled — assigned to ``self.X`` (or a
   ``self`` container) the resource moves to the class ledger
   (pass 3's domain), ``return``/``yield`` hands it to the caller,
   and passing it as an argument to any call consumes it (the
   registering-call pattern: ``self._io[r] = _ChildIO(proc, r)``).
   A release reached only on the fall-through path (no ``finally``,
   not adjacent to the acquire) is still a finding: the raise edge
   leaks.

2. **bracket-discipline** (:func:`check_brackets`): paired
   mutate/unmutate operations declared in :data:`BRACKETS` (the
   gateway serve counter / ``_serve_done``, the async-window
   in-flight list, the mailbox ``claim_all``/``park`` exactly-once
   pair, metrics gauge ``inc``/``dec``) must be exception-safe — the
   release must postdominate the acquire via ``finally``, be
   reachable on every raise edge (a broad ``except`` that reparks),
   or the acquire must hand off *immediately* (next statement,
   climbing out of ``with``/``if``) to a function that releases in
   ITS ``finally`` (``Thread(target=self._serve_execute)`` where
   ``_serve_execute``'s whole body is try/finally → ``_serve_done``).
   Anything else can strand a slot when the serve thread throws.

3. **shutdown-completeness** (:func:`check_shutdown_completeness`):
   a class-level ledger — every resource a class acquires in
   ``__init__``/``start`` (one level deep: helpers they call count)
   must be released in its ``close``/``stop``/``shutdown``/
   ``__exit__`` (one level deep again); every non-daemon ``Thread``
   joined by its owner; every ``Popen`` waited; listener sockets
   closed; attributes typed as *other resource-owning product
   classes* (``self._ch = WorkerChannel(...)``) released through
   their own close/stop.  Daemon threads whose target touches a
   ``threading`` lock are flagged as interpreter-teardown hazards
   unless their owner joins them on close (daemon threads die
   mid-critical-section at interpreter exit; a lock held then
   deadlocks other atexit work).

Deliberate leaks live in the module-local ``_LINT_LIFECYCLE_OK``
exemption table — ``{"Class.method:resource": "why"}`` for passes
1–2 (``resource`` is the vocabulary kind or the bracket name) and
``{"Class:attr": "why"}`` for pass 3 — mirroring
``_LINT_BLOCKING_OK``.  Stdlib-only (ast), shares the finding shape
with :mod:`selfcheck`, and is wired into ``run_self_lint`` /
``nbd-torch-lint --self`` / ``%dist_lint self``; the per-class
ledger is exportable (``nbd-torch-lint --shutdown-ledger``).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from .concur import _FnWalker, _dotted, _str_table
from .selfcheck import SelfFinding, _iter_product_files, _parse, _rel

# ----------------------------------------------------------------------
# vocabulary

# Dotted (and bare, for `from x import Y` style) constructor paths →
# resource kind.
_ACQUIRE_CTORS = {
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "socket.socketpair": "socket",
    "subprocess.Popen": "process",
    "Popen": "process",
    "threading.Thread": "thread",
    "Thread": "thread",
    "mmap.mmap": "mmap",
    "tempfile.TemporaryDirectory": "tempdir",
    "TemporaryDirectory": "tempdir",
    "ThreadingHTTPServer": "server",
    "HTTPServer": "server",
}

# Per-kind release method names (called ON the resource).
_RELEASES = {
    "socket": frozenset({"close", "detach"}),
    "process": frozenset({"wait", "communicate"}),
    "thread": frozenset({"join"}),
    "mmap": frozenset({"close"}),
    "tempdir": frozenset({"cleanup"}),
    "server": frozenset({"server_close"}),
    "file": frozenset({"close"}),
}

# Release methods accepted for attributes typed as resource-owning
# product classes (tier B of the class ledger).
_OWNER_RELEASES = frozenset({"close", "stop", "shutdown",
                             "shutdown_all", "stop_all", "detach"})

# Methods that count as a class's shutdown surface.
_CLOSE_METHODS = ("close", "stop", "shutdown", "__exit__", "__del__",
                  "cleanup", "stop_all", "shutdown_all")

# Declared bracket pairs (pass 2).  ``acquire``/``release`` are
# matcher specs; see _match_bracket_*.  Declaring a bracket that the
# current tree never performs is fine — it simply never fires.
BRACKETS = (
    # The gateway serve counter: incremented on the listener thread
    # (`self._serving[name] = self._serving.get(name, 0) + 1`),
    # released by `_serve_done` in the serve thread's finally.
    {"name": "serve-slot",
     "acquire": {"kind": "subscript-incr", "attr": "_serving"},
     "release": {"kind": "call", "name": "_serve_done"}},
    # The async executor's in-flight window entry/exit.
    {"name": "async-window",
     "acquire": {"kind": "attr-method", "attr": "_inflight",
                 "name": "append"},
     "release": {"kind": "attr-method", "attr": "_inflight",
                 "name": "remove"}},
    # The mailbox exactly-once pair: a destructive claim must be
    # reparked on every raise edge or the results are lost on both
    # sides.
    {"name": "mailbox-claim",
     "acquire": {"kind": "call", "name": "claim_all"},
     "release": {"kind": "call", "name": "park"}},
    # Metrics gauge up/down pairs (occupancy-style gauges): an `inc`
    # with a matching `dec` in the same function's module must not
    # strand the gauge high on a raise edge.
    {"name": "gauge-updown",
     "acquire": {"kind": "attr-method", "attr": None, "name": "inc_gauge"},
     "release": {"kind": "attr-method", "attr": None, "name": "dec_gauge"}},
)


def _exempt(table: dict, key: str) -> bool:
    return key in table


# ----------------------------------------------------------------------
# shared AST plumbing


def _ctor_kind(call: ast.AST) -> str | None:
    """Resource kind of an acquire-vocabulary constructor call, or
    None.  Write-mode ``open`` is kind "file"."""
    if not isinstance(call, ast.Call):
        return None
    dotted = _dotted(call.func)
    if dotted in _ACQUIRE_CTORS:
        return _ACQUIRE_CTORS[dotted]
    if dotted is not None and "." in dotted:
        # `http.server.ThreadingHTTPServer` etc.: match the last
        # attribute too so alias imports don't hide a server.
        tail = dotted.rsplit(".", 1)[1]
        if tail in ("ThreadingHTTPServer",):
            return "server"
    if isinstance(call.func, ast.Name) and call.func.id == "open" \
            and _FnWalker._open_writes(call):
        return "file"
    return None


def _thread_is_daemon(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


def _self_attr_of(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _Blocks:
    """Statement-position index for one function: parent links, the
    (block-list, index) of every statement, and finally/handler
    membership — the postdomination approximations both passes
    share."""

    def __init__(self, fn: ast.AST):
        self.parent: dict = {}
        self.stmt_pos: dict = {}       # stmt -> (block list, index)
        self.in_finally: set = set()   # stmts under any finalbody
        for node in ast.walk(fn):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        for node in ast.walk(fn):
            for name in ("body", "orelse", "finalbody"):
                block = getattr(node, name, None)
                if isinstance(block, list):
                    for i, stmt in enumerate(block):
                        if isinstance(stmt, ast.stmt):
                            self.stmt_pos[stmt] = (block, i)
            if isinstance(node, ast.Try):
                for stmt in node.finalbody:
                    for sub in ast.walk(stmt):
                        self.in_finally.add(sub)

    def stmt_of(self, node: ast.AST) -> ast.stmt | None:
        while node is not None and node not in self.stmt_pos:
            node = self.parent.get(node)
        return node

    def next_stmt(self, stmt: ast.stmt) -> ast.stmt | None:
        """The statement that executes immediately after ``stmt`` on
        the fall-through path, climbing out of with/if bodies when
        ``stmt`` closes them (a `with lock:` whose last statement is
        the acquire falls through to the with's sibling).  Stops at
        try/loop bodies — an exception or another iteration breaks
        the adjacency."""
        while stmt is not None:
            block, i = self.stmt_pos.get(stmt, (None, None))
            if block is None:
                return None
            if i + 1 < len(block):
                return block[i + 1]
            parent = self.parent.get(stmt)
            # climb only through containers whose fall-through leads
            # to their own next sibling
            if isinstance(parent, (ast.With, ast.If)):
                stmt = parent
                continue
            return None
        return None

def _tries_covering(fn: ast.AST, node: ast.AST) -> list:
    """Try statements whose try-BODY contains ``node`` (so the
    finalbody / handlers run if anything after it raises)."""
    out = []
    for t in ast.walk(fn):
        if not isinstance(t, ast.Try):
            continue
        for stmt in t.body:
            found = any(sub is node for sub in ast.walk(stmt))
            if found:
                out.append(t)
                break
    return out


# ----------------------------------------------------------------------
# pass 1: resource-leak (function-local)


@dataclass
class _Local:
    names: tuple          # bound local name(s)
    kind: str
    line: int
    stmt: ast.stmt        # the binding statement


def _acquires_in(fn) -> tuple[list[_Local], set]:
    """Function-local acquire bindings, plus the set of acquire Call
    nodes that are already satisfied/consumed at the acquire site
    (with-blocks, direct-argument use, self-assignment)."""
    satisfied: set = set()
    locals_: list[_Local] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                if _ctor_kind(item.context_expr):
                    satisfied.add(item.context_expr)
        elif isinstance(node, ast.Call):
            # an acquire constructed directly inside another call is
            # consumed by that call (registering-call pattern), and a
            # method chained on the constructor (`Thread(...).start()`)
            # keeps no reference to release — only daemon threads may
            # do that (handled below).
            for arg in list(node.args) + [kw.value
                                          for kw in node.keywords]:
                if _ctor_kind(arg):
                    satisfied.add(arg)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        kind = _ctor_kind(node.value)
        if kind is None:
            continue
        if kind == "thread" and _thread_is_daemon(node.value):
            # Daemon threads die with the process by design; their
            # hazards are pass 3's (teardown) domain.
            satisfied.add(node.value)
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name):
            locals_.append(_Local((tgt.id,), kind, node.lineno, node))
        elif isinstance(tgt, ast.Tuple) and kind == "socket" \
                and all(isinstance(e, ast.Name) for e in tgt.elts):
            # `r, w = socket.socketpair()` — each end is its own
            # socket and needs its own release (closing one end must
            # not satisfy the check for the other).
            for e in tgt.elts:
                locals_.append(_Local((e.id,), kind, node.lineno,
                                      node))
        else:
            # self.X = acquire → the class ledger (pass 3) owns it.
            satisfied.add(node.value)
    return locals_, satisfied


def _disposes(fn, res: _Local, blocks: _Blocks) -> tuple[str, bool]:
    """How the function disposes of a local resource:
    ``("transferred"|"released"|"leaked", exception_safe)``."""
    names = set(res.names)
    release_names = _RELEASES[res.kind]
    released_nodes = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)) \
                and node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name) and sub.id in names:
                    return "transferred", True      # caller owns
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in names:
            # v assigned into self state (attr or container item)
            for t in node.targets:
                attr_t = t.value if isinstance(t, ast.Subscript) else t
                if _self_attr_of(attr_t) is not None:
                    return "transferred", True      # class ledger
        if isinstance(node, ast.Call):
            fn_attr = node.func if isinstance(node.func, ast.Attribute)\
                else None
            if fn_attr is not None \
                    and isinstance(fn_attr.value, ast.Name) \
                    and fn_attr.value.id in names:
                if fn_attr.attr in release_names:
                    released_nodes.append(node)
                continue
            for arg in list(node.args) + [kw.value
                                          for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name) and sub.id in names:
                        return "transferred", True  # consumed by call
    if not released_nodes:
        return "leaked", False
    # Exception-safety of the release: a finally covers every edge;
    # so does being the very next statement after the acquire (no
    # raise window).
    for rel in released_nodes:
        if rel in blocks.in_finally:
            return "released", True
        rel_stmt = blocks.stmt_of(rel)
        if rel_stmt is not None \
                and blocks.next_stmt(res.stmt) is rel_stmt:
            return "released", True
    return "released", False


def check_resource_leaks(root: str) -> list[SelfFinding]:
    findings: list[SelfFinding] = []
    for path in _iter_product_files(root):
        tree = _parse(path)
        if tree is None:
            continue
        rel = _rel(root, path).replace(os.sep, "/")
        exempt = _str_table(tree, "_LINT_LIFECYCLE_OK")

        def scan(fn, qname):
            locals_, satisfied = _acquires_in(fn)
            blocks = _Blocks(fn)
            for res in locals_:
                if res.stmt.value in satisfied:
                    continue
                if _exempt(exempt, f"{qname}:{res.kind}"):
                    continue
                verdict, safe = _disposes(fn, res, blocks)
                if verdict == "leaked":
                    findings.append(SelfFinding(
                        rel, res.line, "resource-leak",
                        f"{qname}: {res.kind} "
                        f"{'/'.join(res.names)!r} is acquired here "
                        f"but never released, returned, stored on "
                        f"self, or passed on — use a with-block or "
                        f"try/finally, or exempt "
                        f"'{qname}:{res.kind}' in _LINT_LIFECYCLE_OK "
                        f"with a reason"))
                elif verdict == "released" and not safe:
                    findings.append(SelfFinding(
                        rel, res.line, "resource-leak",
                        f"{qname}: {res.kind} "
                        f"{'/'.join(res.names)!r} is released only "
                        f"on the fall-through path — an exception "
                        f"between acquire and release leaks it; "
                        f"move the release into a finally (or a "
                        f"with-block), or exempt "
                        f"'{qname}:{res.kind}' in _LINT_LIFECYCLE_OK"))

        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        scan(sub, f"{node.name}.{sub.name}")
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                scan(node, node.name)
    return sorted(findings, key=lambda f: (f.file, f.line))


# ----------------------------------------------------------------------
# pass 2: bracket-discipline


def _match_bracket_acquire(node: ast.AST, spec: dict) -> bool:
    kind = spec["kind"]
    if kind == "subscript-incr":
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Subscript) \
                and _self_attr_of(node.target.value) == spec["attr"]:
            return True
        return (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)
                and _self_attr_of(node.targets[0].value)
                == spec["attr"]
                and isinstance(node.value, ast.BinOp)
                and isinstance(node.value.op, ast.Add))
    if kind == "attr-method":
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == spec["name"]):
            return False
        if spec.get("attr") is not None:
            return _self_attr_of(node.func.value) == spec["attr"]
        if spec.get("recv_in") is not None:
            # Pair by receiver: `self.g.inc()` only brackets with a
            # `.dec()` on the SAME dotted receiver — a monotonic
            # counter's inc in a module that decs some other gauge
            # must not arm.
            return _dotted(node.func.value) in spec["recv_in"]
        return True
    if kind == "call":
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == spec["name"])
    return False


def _match_bracket_release(node: ast.AST, spec: dict) -> bool:
    return _match_bracket_acquire(node, spec)


def _fn_releases_in_finally(fn, spec: dict) -> bool:
    """True when every path through ``fn`` runs the release: its body
    (past a docstring) is one try whose finalbody contains the
    release op — the `_serve_execute` shape."""
    body = list(fn.body)
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    if len(body) != 1 or not isinstance(body[0], ast.Try):
        return False
    for stmt in body[0].finalbody:
        for sub in ast.walk(stmt):
            if _match_bracket_release(sub, spec):
                return True
    return False


def _releasing_fns(tree: ast.Module, spec: dict) -> set:
    """Names (bare and Class.method) of functions in this module that
    release the bracket on every path."""
    out: set = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)) \
                        and _fn_releases_in_finally(sub, spec):
                    out.add(sub.name)
                    out.add(f"{node.name}.{sub.name}")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _fn_releases_in_finally(node, spec):
                out.add(node.name)
    return out


def _stmt_hands_off(stmt: ast.stmt, releasing: set, spec: dict) -> bool:
    """Does this statement guarantee the release?  Either it performs
    the release op itself, or it hands off to a releasing function —
    a direct call, or ``Thread(target=<releasing>)`` (the spawned
    thread's whole body releases in its finally)."""
    for sub in ast.walk(stmt):
        if _match_bracket_release(sub, spec):
            return True
        if not isinstance(sub, ast.Call):
            continue
        dotted = _dotted(sub.func)
        if dotted is not None \
                and dotted.split(".")[-1] in releasing:
            return True
        if _ctor_kind(sub) == "thread":
            for kw in sub.keywords:
                if kw.arg != "target":
                    continue
                tgt = _dotted(kw.value)
                if tgt is not None \
                        and tgt.split(".")[-1] in releasing:
                    return True
    return False


def check_brackets(root: str) -> list[SelfFinding]:
    findings: list[SelfFinding] = []
    for path in _iter_product_files(root):
        tree = _parse(path)
        if tree is None:
            continue
        rel = _rel(root, path).replace(os.sep, "/")
        exempt = _str_table(tree, "_LINT_LIFECYCLE_OK")

        # gauge-updown arms only for receivers the module actually
        # calls .dec() on (counters are monotonic; only up/down
        # gauges pair, and only with themselves).
        dec_recvs = {r for r in (
            _dotted(n.func.value) for n in ast.walk(tree)
            if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "dec") if r is not None}
        armed = []
        for br in BRACKETS:
            spec_a, spec_r = dict(br["acquire"]), dict(br["release"])
            if br["name"] == "gauge-updown":
                if not dec_recvs:
                    continue
                spec_a["name"], spec_r["name"] = "inc", "dec"
                spec_a["recv_in"] = spec_r["recv_in"] = dec_recvs
            armed.append((br["name"], spec_a, spec_r,
                          _releasing_fns(tree, spec_r)))

        def scan(fn, qname):
            blocks = _Blocks(fn)
            for name, spec_a, spec_r, releasing in armed:
                for node in ast.walk(fn):
                    if not _match_bracket_acquire(node, spec_a):
                        continue
                    if _exempt(exempt, f"{qname}:{name}"):
                        continue
                    if _bracket_safe(fn, node, blocks, spec_r,
                                     releasing):
                        continue
                    findings.append(SelfFinding(
                        rel, node.lineno, "bracket-discipline",
                        f"{qname}: bracket {name!r} is acquired "
                        f"here but its release does not postdominate "
                        f"— no enclosing try/finally (or broad "
                        f"except) releases it and the next statement "
                        f"is not a release/hand-off, so a raise "
                        f"strands the bracket; wrap in try/finally, "
                        f"release in an except that re-raises, or "
                        f"exempt '{qname}:{name}' in "
                        f"_LINT_LIFECYCLE_OK with a reason"))

        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        scan(sub, f"{node.name}.{sub.name}")
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                scan(node, node.name)
    return sorted(findings, key=lambda f: (f.file, f.line))


def _bracket_safe(fn, node: ast.AST, blocks: _Blocks, spec_r: dict,
                  releasing: set) -> bool:
    # (a) a try whose body contains the acquire releases in its
    # finalbody or in a broad except handler
    for t in _tries_covering(fn, node):
        for stmt in list(t.finalbody) + [
                s for h in t.handlers
                if h.type is None
                or (isinstance(h.type, ast.Name)
                    and h.type.id in ("Exception", "BaseException"))
                for s in h.body]:
            if _stmt_hands_off(stmt, releasing, spec_r):
                return True
    # (b) the statement immediately after the acquire (climbing out
    # of with/if) releases or hands off — zero raise window
    stmt = blocks.stmt_of(node)
    if stmt is not None:
        nxt = blocks.next_stmt(stmt)
        if nxt is not None and _stmt_hands_off(nxt, releasing, spec_r):
            return True
    # (c) the acquiring function itself releases on every path (the
    # whole body is try/finally → release): self-reported safe
    if _fn_releases_in_finally(fn, spec_r):
        return True
    return False


# ----------------------------------------------------------------------
# pass 3: shutdown-completeness (the class ledger)


@dataclass
class _ClassLedger:
    name: str
    relpath: str
    line: int
    # attr -> {"kind", "line", "daemon", "target", "via"}
    resources: dict = field(default_factory=dict)
    close_methods: list = field(default_factory=list)
    # attr -> set of method names called on self.attr inside the
    # shutdown surface
    released: dict = field(default_factory=dict)
    joined_threads: set = field(default_factory=set)


def _methods_of(cls: ast.ClassDef) -> dict:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _collect_ledger(cls: ast.ClassDef, relpath: str,
                    owner_classes: set, *,
                    resources_only: bool = False) -> _ClassLedger:
    """``resources_only`` skips the shutdown-surface release/alias
    scan — the cheap tier-A probe ``build_ledgers`` uses to decide
    which class NAMES count as resource owners."""
    led = _ClassLedger(cls.name, relpath, cls.lineno)
    methods = _methods_of(cls)

    def init_like(names):
        """The named methods plus self-helpers they call (one level)."""
        seen, out = set(), []
        for name in names:
            fn = methods.get(name)
            if fn is None or name in seen:
                continue
            seen.add(name)
            out.append(fn)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self" \
                        and node.func.attr in methods \
                        and node.func.attr not in seen:
                    seen.add(node.func.attr)
                    out.append(methods[node.func.attr])
        return out

    for fn in init_like(["__init__", "start", "open"]):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) \
                    or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            kind = _ctor_kind(node.value)
            if kind is not None:
                attrs = []
                if _self_attr_of(tgt) is not None:
                    attrs = [(_self_attr_of(tgt),)]
                elif isinstance(tgt, ast.Tuple) and kind == "socket":
                    attrs = [tuple(a for a in
                                   (_self_attr_of(e)
                                    for e in tgt.elts)
                                   if a is not None)]
                for group in attrs:
                    for attr in group:
                        target = None
                        if kind == "thread":
                            for kw in node.value.keywords:
                                if kw.arg == "target":
                                    target = _dotted(kw.value)
                        led.resources.setdefault(attr, {
                            "kind": kind, "line": node.lineno,
                            "daemon": (kind == "thread"
                                       and _thread_is_daemon(
                                           node.value)),
                            "target": target, "via": fn.name})
                continue
            # tier B: attr typed as a resource-owning product class
            attr = _self_attr_of(tgt)
            if attr is None or not isinstance(node.value, ast.Call):
                continue
            ctor = node.value.func
            cname = (ctor.id if isinstance(ctor, ast.Name)
                     else ctor.attr
                     if isinstance(ctor, ast.Attribute) else None)
            if cname in owner_classes and cname != cls.name:
                led.resources.setdefault(attr, {
                    "kind": f"owner:{cname}", "line": node.lineno,
                    "daemon": False, "target": None, "via": fn.name})

    led.close_methods = [n for n in _CLOSE_METHODS if n in methods]
    if resources_only:
        return led
    for fn in init_like(list(led.close_methods)):
        # Local aliases of self attributes inside the shutdown
        # surface: `ch, self._ch = self._ch, None` + `ch.close()`,
        # `d = self._driver` + `d.join()`, and the close-loop
        # `for s in (self._a, self._b): s.close()` all release the
        # underlying attribute.
        aliases: dict[str, set] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
                pairs = []
                if isinstance(tgt, ast.Tuple) \
                        and isinstance(val, ast.Tuple) \
                        and len(tgt.elts) == len(val.elts):
                    pairs = list(zip(tgt.elts, val.elts))
                else:
                    pairs = [(tgt, val)]
                for t, v in pairs:
                    if isinstance(t, ast.Name):
                        a = _self_attr_of(v)
                        if a is not None:
                            aliases.setdefault(t.id, set()).add(a)
            elif isinstance(node, ast.For) \
                    and isinstance(node.target, ast.Name) \
                    and isinstance(node.iter, (ast.Tuple, ast.List)):
                attrs = {a for a in (_self_attr_of(e)
                                     for e in node.iter.elts)
                         if a is not None}
                if attrs:
                    aliases.setdefault(node.target.id, set()) \
                        .update(attrs)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                recv = node.func.value
                attrs = set()
                a = _self_attr_of(recv)
                if a is not None:
                    attrs = {a}
                elif isinstance(recv, ast.Name):
                    attrs = aliases.get(recv.id, set())
                for attr in attrs:
                    led.released.setdefault(attr, set()).add(
                        node.func.attr)
                    if node.func.attr == "join":
                        led.joined_threads.add(attr)
    return led


def build_ledgers(root: str) -> tuple[list[_ClassLedger], dict]:
    """All class ledgers plus ``{relpath: exemption_table}``."""
    trees: list[tuple[str, ast.Module, dict]] = []
    for path in _iter_product_files(root):
        tree = _parse(path)
        if tree is None:
            continue
        rel = _rel(root, path).replace(os.sep, "/")
        trees.append((rel, tree, _str_table(tree,
                                            "_LINT_LIFECYCLE_OK")))
    # Tier A first: which classes own stdlib resources (their names
    # feed tier B typing — name-based like concur's attr typing, so
    # best-effort across same-named classes).
    owner_classes: set = set()
    for rel, tree, _ex in trees:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                led = _collect_ledger(node, rel, set(),
                                      resources_only=True)
                if led.resources:
                    owner_classes.add(node.name)
    ledgers: list[_ClassLedger] = []
    exemptions: dict = {}
    for rel, tree, ex in trees:
        exemptions[rel] = ex
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                led = _collect_ledger(node, rel, owner_classes)
                if led.resources:
                    ledgers.append(led)
    return ledgers, exemptions


def _daemon_touches_lock(led: _ClassLedger, attr: str,
                         lock_fns: set, concur) -> bool:
    target = led.resources[attr].get("target") or ""
    if not target.startswith("self.") or "." in target[5:]:
        return False
    qname = f"{led.name}.{target[5:]}"
    if qname in lock_fns:
        return True
    # one level: the target's direct self-method callees
    summary = concur._fn(qname)
    if summary is None:
        return False
    return any(s.name in lock_fns for s in summary.direct("call"))


def check_shutdown_completeness(root: str, *,
                                concur=None) -> list[SelfFinding]:
    ledgers, exemptions = build_ledgers(root)
    # Functions that acquire a known threading lock (directly, or via
    # a `*_locked` entry lockset) — the concur collector already knows.
    if concur is None:
        from .concur import ConcurAnalysis
        concur = ConcurAnalysis(root)
    lock_fns: set = set()
    for mod in concur.col.modules.values():
        for qname, summary in mod.fns.items():
            if any(s.kind == "acquire" for s in summary.sites) \
                    or any(s.held for s in summary.sites):
                lock_fns.add(qname)

    findings: list[SelfFinding] = []
    for led in ledgers:
        exempt = exemptions.get(led.relpath, {})
        if not led.close_methods:
            # Only resources that actually need a release demand a
            # shutdown surface — a daemon thread that touches no lock
            # dies harmlessly with the process.
            unexempt = [
                a for a, info in led.resources.items()
                if not _exempt(exempt, f"{led.name}:{a}")
                and not (info["kind"] == "thread" and info["daemon"]
                         and not _daemon_touches_lock(
                             led, a, lock_fns, concur))]
            if unexempt:
                findings.append(SelfFinding(
                    led.relpath, led.line, "shutdown-completeness",
                    f"{led.name} acquires "
                    f"{', '.join(sorted(unexempt))} but defines no "
                    f"close/stop/shutdown/__exit__ — add a shutdown "
                    f"surface or exempt '{led.name}:<attr>' in "
                    f"_LINT_LIFECYCLE_OK with a reason"))
            continue
        surface = "/".join(led.close_methods)
        for attr, info in sorted(led.resources.items()):
            if _exempt(exempt, f"{led.name}:{attr}"):
                continue
            kind = info["kind"]
            released = led.released.get(attr, set())
            if kind == "thread":
                if info["daemon"]:
                    if attr in led.joined_threads:
                        continue
                    if _daemon_touches_lock(led, attr, lock_fns,
                                            concur):
                        findings.append(SelfFinding(
                            led.relpath, info["line"],
                            "shutdown-completeness",
                            f"{led.name}.{attr}: daemon thread "
                            f"(target {info['target']}) takes "
                            f"threading locks but is never joined in "
                            f"{surface} — at interpreter teardown "
                            f"daemon threads die mid-critical-"
                            f"section and a held lock deadlocks "
                            f"atexit work; join it (bounded) after "
                            f"signalling stop, or exempt "
                            f"'{led.name}:{attr}' with a reason"))
                    continue
                if attr not in led.joined_threads:
                    findings.append(SelfFinding(
                        led.relpath, info["line"],
                        "shutdown-completeness",
                        f"{led.name}.{attr}: non-daemon thread is "
                        f"never joined in {surface} — the process "
                        f"cannot exit while it runs; join it or "
                        f"exempt '{led.name}:{attr}'"))
                continue
            ok_names = (_OWNER_RELEASES if kind.startswith("owner:")
                        else _RELEASES[kind])
            if kind == "server":
                # shutdown() alone stops serve_forever but leaks the
                # listening fd; server_close() (or close) is the
                # release.
                ok_names = _RELEASES["server"] | {"close"}
            if not (released & ok_names):
                what = (f"resource of class {kind[6:]}"
                        if kind.startswith("owner:") else kind)
                need = "/".join(sorted(ok_names))
                findings.append(SelfFinding(
                    led.relpath, info["line"], "shutdown-completeness",
                    f"{led.name}.{attr}: {what} acquired in "
                    f"{info['via']} is never released in {surface} "
                    f"(expected a {need} call on self.{attr}); "
                    f"release it or exempt '{led.name}:{attr}' in "
                    f"_LINT_LIFECYCLE_OK with a reason"))
    return sorted(findings, key=lambda f: (f.file, f.line))


def shutdown_ledger(root: str) -> dict:
    """The per-class resource ledger as a JSON-ready report
    (``nbd-torch-lint --shutdown-ledger``): every registered class, every
    resource it owns, and how its shutdown surface releases it."""
    ledgers, exemptions = build_ledgers(root)
    out: dict = {}
    for led in sorted(ledgers, key=lambda l: (l.relpath, l.line)):
        exempt = exemptions.get(led.relpath, {})
        # Same-named classes in different modules must not silently
        # overwrite each other's rows — qualify the later one.
        key = led.name if led.name not in out \
            else f"{led.name} ({led.relpath})"
        entry = {"file": led.relpath, "line": led.line,
                 "shutdown_surface": led.close_methods,
                 "resources": []}
        for attr, info in sorted(led.resources.items()):
            released = sorted(led.released.get(attr, ()))
            entry["resources"].append({
                "attr": attr, "kind": info["kind"],
                "line": info["line"], "daemon": info["daemon"],
                "acquired_in": info["via"],
                "released_by": released,
                "exempt": exempt.get(f"{led.name}:{attr}"),
            })
        out[key] = entry
    return out


# ----------------------------------------------------------------------
# entry point


def run_lifecycle_lint(root: str, concur=None
                       ) -> dict[str, list[SelfFinding]]:
    """The three lifecycle passes; ``{pass_name: findings}``.
    ``concur`` (a :class:`~.concur.ConcurAnalysis`) lets
    ``run_self_lint`` share one collection pass with the lock
    passes."""
    return {
        "resource-leak": check_resource_leaks(root),
        "bracket-discipline": check_brackets(root),
        "shutdown-completeness": check_shutdown_completeness(
            root, concur=concur),
    }
