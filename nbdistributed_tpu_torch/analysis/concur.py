"""Concurrency self-analysis: the lockset passes over the port's own
source (a copy of ``nbdistributed_tpu/analysis/concur.py``; the tree
it walks is :mod:`selfcheck`'s product tree).

The framework is a genuinely multithreaded system — gateway serve
threads, the tenant-plane listener, the supervisor, the hang watchdog,
the manifest writer thread, and reader-thread callbacks all share
locks — and review of the gateway found, by hand, three expensive bug
shapes:
a lock held across blocking IO (the manifest ``json.dump`` under the
daemon ``_lock`` stalling every tenant frame), lock-order inversions,
and user/reader callbacks invoked while a lock is held.  This module
mechanizes all three so they can never regress silently.

For every class (and module) in the product tree it computes, per
function, the set of locks held at each call site — tracking
``with self._lock:`` blocks, explicit ``acquire()``/``release()``
pairs, and the ``*_locked`` helper convention (a method named
``foo_locked`` ASSERTS its callers hold the class's primary lock, so
its body is analyzed with that lock held).  Lock identity is the
qualified attribute (``GatewayDaemon._lock``,
``ResultMailbox._mlock``, ``preflight::_lock`` for module-level
locks); only attributes *proven* to be locks — assigned from
``threading.Lock()`` / ``RLock()`` / ``Condition()`` — participate,
so ``block_until_ready`` never false-positives.

Three passes run over the locksets:

1. **lock-order graph** (:func:`check_lock_order`): a directed edge
   ``A → B`` for every site that acquires ``B`` while holding ``A``.
   Any cycle — including the one-node cycle of re-acquiring a
   non-reentrant ``Lock`` already held — is a potential deadlock and
   a finding.  The graph itself is reviewable documentation:
   ``nbd-torch-lint --lock-graph`` emits it as Graphviz dot, with reentrant (RLock) self-edges drawn dashed.

2. **blocking-call-under-lock** (:func:`check_blocking_under_lock`):
   a declared vocabulary of blocking operations (socket
   ``send*``/``recv*``/``sendall``, ``json.dump`` + ``os.replace``,
   ``time.sleep``, ``subprocess.*``, ``send_to_ranks``/``request``,
   write-mode ``open``, ``Event.wait``/``Thread.join``) may not be
   reached while any lock is held.  Per-site exemptions live in the
   module's ``_LINT_BLOCKING_OK = {"Class.method:op": "why"}`` table
   (mirroring ``_LINT_SINGLE_WRITER``) — e.g. the transport's
   ``wlock`` exists precisely to serialize frame writes, and the
   gateway's ``_manifest_lock`` exists precisely to serialize the
   manifest's ``json.dump`` + ``os.replace``.

3. **callback-reentrancy** (:func:`check_callback_under_lock`):
   invoking a *stored callback* (``on_*`` attributes, ``*_cb`` /
   ``*_callback`` / ``*_fn`` / ``*_hook`` names, or a local bound
   from one — including ``for cb in self._notify_callbacks:``) while
   holding a lock is a finding: the callback may re-enter the locking
   object, the gateway's reader-callback deadlock shape.  Exemptions:
   ``_LINT_CALLBACK_OK = {"Class.method:name": "why"}``.

Calls are resolved **one level deep**, like :mod:`effects`:
``self.helper()`` under a lock pulls in ``helper``'s direct blocking
ops, callback invocations, and lock acquisitions; calls through a
constructor-typed attribute (``self.registry = TenantRegistry(...)``
in ``__init__`` types every ``*.registry.hello()`` receiver) resolve
cross-class, which is how ``tenant.mailbox.claim_all()`` under the
daemon lock contributes the ``GatewayDaemon._lock →
ResultMailbox._mlock`` edge.  Anything deeper, or any receiver the
analyzer cannot type, is simply not followed — the passes are
deliberately vocabulary-bounded, never exhaustive, so every finding
is cheap to verify by hand.

Stdlib-only (ast + re), shares the finding shape with
:mod:`selfcheck`, and is wired into ``run_self_lint`` /
``nbd-torch-lint --self`` / ``%dist_lint self``.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from .selfcheck import SelfFinding, _iter_product_files, _parse, _rel

# ----------------------------------------------------------------------
# vocabulary

# Constructors that make an attribute a lock.  Condition wraps a lock
# and blocks on acquire exactly the same way.
_LOCK_CTORS = {"Lock": False, "RLock": True, "Condition": False}

# Dotted call paths that block (module functions).
_BLOCKING_DOTTED = {
    "time.sleep", "json.dump", "pickle.dump", "os.replace",
    "subprocess.run", "subprocess.Popen", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
}

# Method names that block regardless of receiver: socket send/recv
# family, the control-plane senders, request/response round trips,
# process interaction, and the wait/join family (an Event.wait or
# Thread.join under a lock is a classic deadlock shape).
_BLOCKING_METHODS = frozenset({
    "sendall", "sendto", "sendmsg", "send",
    "recv", "recvfrom", "recv_into", "recvmsg",
    "send_to_ranks", "send_to_rank", "send_to_all", "post",
    "request", "communicate", "wait", "join",
})

# Stored-callback name shapes.  Broad on purpose: an invocation is
# only a finding when a lock is held, so breadth costs nothing on
# lock-free code (models/, ops/ …).  Registration APIs
# (`add_death_callback`, `set_output_callback`) are verb-prefixed
# method calls, not invocations — excluded.
_CB_NAME = re.compile(
    r"^on_[a-z0-9_]+$|.*_cb$|.*_callback$|.*_fn$|.*_hook$")
_CB_REGISTRATION = re.compile(
    r"^(add|remove|set|register|unregister|clear)_")
_CB_CONTAINER = re.compile(r".*_(callbacks|cbs|hooks)$")

_WRITE_MODE = re.compile(r"[wax+]")


# ----------------------------------------------------------------------
# shared shapes


@dataclass
class _Site:
    """One interesting event inside a function body."""

    kind: str            # "acquire" | "blocking" | "callback" | "call"
    name: str            # lock qname / op name / callback name / callee
    line: int
    held: frozenset = frozenset()
    recv_attr: str | None = None   # for kind="call": typed-attr receiver


@dataclass
class _FnSummary:
    qname: str                     # "Class.method" or "function"
    relpath: str
    cls: str | None
    sites: list = field(default_factory=list)

    def direct(self, kind: str):
        return [s for s in self.sites if s.kind == kind]


@dataclass
class _ModuleInfo:
    relpath: str
    tree: ast.Module
    # lock qname -> reentrant?
    locks: dict = field(default_factory=dict)
    # "Class.method" / "function" -> _FnSummary
    fns: dict = field(default_factory=dict)
    blocking_ok: dict = field(default_factory=dict)
    callback_ok: dict = field(default_factory=dict)
    # class name -> {attr: class-name-it-was-constructed-from}
    attr_types: dict = field(default_factory=dict)
    # class name -> set of method names (to tell methods from
    # stored-callback attributes)
    methods: dict = field(default_factory=dict)


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` → "a.b.c" (Names/Attributes only)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _str_table(tree: ast.Module, name: str) -> dict[str, str]:
    """Module-level ``NAME = {"key": "why"}`` exemption table."""
    out: dict[str, str] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name
                and isinstance(node.value, ast.Dict)):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) \
                        and isinstance(v, ast.Constant):
                    out[str(k.value)] = str(v.value)
    return out


# ----------------------------------------------------------------------
# collection


def _lock_ctor(value: ast.AST) -> bool | None:
    """``threading.Lock()`` / ``Lock()`` → reentrant? (None: not a
    lock constructor)."""
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    return _LOCK_CTORS.get(name) if name in _LOCK_CTORS else None


class _Collector:
    """Builds a :class:`_ModuleInfo` per file and the global lock /
    attr-type registries."""

    def __init__(self, root: str):
        self.root = root
        self.modules: dict[str, _ModuleInfo] = {}
        # attribute name -> set of class names it was constructed as
        # (from any __init__ `self.X = ClassName(...)`)
        self.attr_classes: dict[str, set] = {}
        # class name -> (module relpath) for summary lookup
        self.class_home: dict[str, str] = {}

    def collect(self) -> None:
        # Phase 1 — registries only (locks, constructor-typed attrs,
        # method sets, exemption tables) over EVERY file, so that the
        # phase-2 body walk can resolve cross-module receivers
        # regardless of file order (daemon.py is walked before
        # tenancy.py declares `mailbox = ResultMailbox()`).
        for path in _iter_product_files(self.root):
            tree = _parse(path)
            if tree is None:
                continue
            rel = _rel(self.root, path).replace(os.sep, "/")
            mod = _ModuleInfo(rel, tree)
            mod.blocking_ok = _str_table(tree, "_LINT_BLOCKING_OK")
            mod.callback_ok = _str_table(tree, "_LINT_CALLBACK_OK")
            self._module_locks(mod)
            for node in tree.body:
                if isinstance(node, ast.ClassDef):
                    self._register_class(mod, node)
            self.modules[rel] = mod
        # Phase 2 — walk function bodies with the full registries.
        for mod in self.modules.values():
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    for fn in (n for n in node.body
                               if isinstance(n, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef))):
                        self._collect_fn(mod, fn, cls=node.name)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self._collect_fn(mod, node, cls=None)

    # -- registries ----------------------------------------------------

    def _module_locks(self, mod: _ModuleInfo) -> None:
        stem = os.path.splitext(os.path.basename(mod.relpath))[0]
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                r = _lock_ctor(node.value)
                if r is not None:
                    q = f"{stem}::{node.targets[0].id}"
                    mod.locks[q] = r

    def _register_class(self, mod: _ModuleInfo, cls: ast.ClassDef) -> None:
        methods = {n.name for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        mod.methods[cls.name] = methods
        self.class_home.setdefault(cls.name, mod.relpath)
        attr_types: dict[str, str] = {}
        # class-level lock attrs (`_display_lock = threading.Lock()`)
        for node in cls.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                r = _lock_ctor(node.value)
                if r is not None:
                    mod.locks[f"{cls.name}.{node.targets[0].id}"] = r
        # instance attrs assigned anywhere in the class body's methods:
        # locks, and constructor-typed attributes for cross-class
        # resolution.
        for fn in (n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    r = _lock_ctor(node.value)
                    if r is not None:
                        mod.locks[f"{cls.name}.{tgt.attr}"] = r
                        continue
                    if isinstance(node.value, ast.Call):
                        ctor = node.value.func
                        cname = (ctor.id if isinstance(ctor, ast.Name)
                                 else ctor.attr
                                 if isinstance(ctor, ast.Attribute)
                                 else None)
                        if cname and cname[:1].isupper():
                            attr_types[tgt.attr] = cname
                            self.attr_classes.setdefault(
                                tgt.attr, set()).add(cname)
        mod.attr_types[cls.name] = attr_types

    # -- per-function lockset walk -------------------------------------

    def _collect_fn(self, mod: _ModuleInfo, fn, cls: str | None) -> None:
        qname = f"{cls}.{fn.name}" if cls else fn.name
        summary = _FnSummary(qname, mod.relpath, cls)
        entry: frozenset = frozenset()
        if fn.name.endswith("_locked") and cls:
            primary = self._primary_lock(mod, cls)
            if primary:
                entry = frozenset({primary})
        walker = _FnWalker(self, mod, cls, summary)
        walker.walk_block(fn.body, entry)
        mod.fns[qname] = summary

    def _primary_lock(self, mod: _ModuleInfo, cls: str) -> str | None:
        """The lock a ``*_locked`` helper asserts: ``Class._lock`` when
        declared, else the class's only lock."""
        mine = [q for q in mod.locks if q.startswith(cls + ".")]
        for q in mine:
            if q.endswith("._lock"):
                return q
        return mine[0] if len(mine) == 1 else None

    def _lock_qname(self, mod: _ModuleInfo, cls: str | None,
                    node: ast.AST) -> str | None:
        """Resolve a context/receiver expression to a known lock."""
        stem = os.path.splitext(os.path.basename(mod.relpath))[0]
        if isinstance(node, ast.Name):
            q = f"{stem}::{node.id}"
            return q if q in mod.locks else None
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls:
                    q = f"{cls}.{node.attr}"
                    if q in mod.locks:
                        return q
                # `OtherClass._display_lock` — class-level lock
                q = f"{base.id}.{node.attr}"
                if q in mod.locks:
                    return q
                # lock reached through a typed attribute is not
                # tracked (one level only)
            # `x.y.lockattr` — try typed-attr receiver: self.A.lock
            if isinstance(base, ast.Attribute):
                owner = self._recv_class(mod, cls, base)
                if owner:
                    home = self.modules.get(self.class_home.get(owner, ""))
                    if home and f"{owner}.{node.attr}" in home.locks:
                        return f"{owner}.{node.attr}"
        return None

    def _recv_class(self, mod: _ModuleInfo, cls: str | None,
                    node: ast.AST) -> str | None:
        """Best-effort class of a receiver expression: ``self.attr``
        via this class's constructor-typed attrs, else any
        unambiguous global ``attr`` → class binding."""
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) \
                    and node.value.id == "self" and cls:
                t = mod.attr_types.get(cls, {}).get(node.attr)
                if t:
                    return t
            cands = self.attr_classes.get(node.attr) or set()
            if len(cands) == 1:
                return next(iter(cands))
        return None


class _FnWalker:
    """Walks one function body tracking the held lockset."""

    def __init__(self, col: _Collector, mod: _ModuleInfo,
                 cls: str | None, summary: _FnSummary):
        self.col = col
        self.mod = mod
        self.cls = cls
        self.summary = summary
        self.cb_aliases: set[str] = set()

    # -- statements ----------------------------------------------------

    def walk_block(self, stmts, held: frozenset) -> frozenset:
        for stmt in stmts:
            held = self.walk_stmt(stmt, held)
        return held

    def walk_stmt(self, stmt, held: frozenset) -> frozenset:
        if isinstance(stmt, ast.With):
            inner = held
            for item in stmt.items:
                self.walk_expr(item.context_expr, held)
                q = self.col._lock_qname(self.mod, self.cls,
                                         item.context_expr)
                if q is not None:
                    self.summary.sites.append(_Site(
                        "acquire", q, stmt.lineno, inner))
                    inner = inner | {q}
            self.walk_block(stmt.body, inner)
            return held
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # Nested defs execute later, on an unknown thread with an
            # unknown lockset — not followed (one level, like effects).
            return held
        if isinstance(stmt, (ast.If,)):
            self.walk_expr(stmt.test, held)
            self.walk_block(stmt.body, held)
            self.walk_block(stmt.orelse, held)
            return held
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.walk_expr(stmt.iter, held)
            self._track_cb_alias_target(stmt.target, stmt.iter)
            self.walk_block(stmt.body, held)
            self.walk_block(stmt.orelse, held)
            return held
        if isinstance(stmt, ast.While):
            self.walk_expr(stmt.test, held)
            self.walk_block(stmt.body, held)
            self.walk_block(stmt.orelse, held)
            return held
        if isinstance(stmt, ast.Try):
            held = self.walk_block(stmt.body, held)
            for h in stmt.handlers:
                self.walk_block(h.body, held)
            self.walk_block(stmt.orelse, held)
            held = self.walk_block(stmt.finalbody, held)
            return held
        if isinstance(stmt, ast.Expr):
            # acquire()/release() as bare statements move the lockset.
            moved = self._acquire_release(stmt.value, held)
            if moved is not None:
                return moved
            self.walk_expr(stmt.value, held)
            return held
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = getattr(stmt, "value", None)
            if value is not None:
                self.walk_expr(value, held)
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    self._track_cb_alias_target(tgt, value)
            return held
        if isinstance(stmt, (ast.Return,)):
            if stmt.value is not None:
                self.walk_expr(stmt.value, held)
            return held
        # Everything else: walk child expressions with the current set.
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self.walk_expr(child, held)
            elif isinstance(child, ast.stmt):
                self.walk_stmt(child, held)
        return held

    def _acquire_release(self, expr, held: frozenset
                         ) -> frozenset | None:
        if not (isinstance(expr, ast.Call)
                and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in ("acquire", "release")):
            return None
        q = self.col._lock_qname(self.mod, self.cls, expr.func.value)
        if q is None:
            return None
        if expr.func.attr == "acquire":
            self.summary.sites.append(_Site("acquire", q,
                                            expr.lineno, held))
            return held | {q}
        return held - {q}

    def _track_cb_alias_target(self, tgt, value) -> None:
        """``cb = self.on_x`` / ``for cb in self._cbs:`` marks ``cb``
        as a callback alias for the rest of the function."""
        if not isinstance(tgt, ast.Name):
            return
        if isinstance(value, ast.Attribute) and (
                _CB_NAME.match(value.attr)
                or _CB_CONTAINER.match(value.attr)):
            self.cb_aliases.add(tgt.id)

    # -- expressions ---------------------------------------------------

    def walk_expr(self, expr, held: frozenset) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._classify_call(node, held)

    def _classify_call(self, call: ast.Call, held: frozenset) -> None:
        fn = call.func
        dotted = _dotted(fn)
        # blocking: dotted module functions
        if dotted in _BLOCKING_DOTTED:
            self.summary.sites.append(_Site("blocking", dotted,
                                            call.lineno, held))
            return
        # blocking: write-mode open()
        if isinstance(fn, ast.Name) and fn.id == "open" \
                and self._open_writes(call):
            self.summary.sites.append(_Site("blocking", "open-write",
                                            call.lineno, held))
            return
        if isinstance(fn, ast.Attribute):
            name = fn.attr
            recv = fn.value
            is_self = isinstance(recv, ast.Name) and recv.id == "self"
            # callback attribute invocation — but a defined method of
            # this class is a method, not a stored callback, and a
            # verb-prefixed name is a registration API, not an
            # invocation.
            if (_CB_NAME.match(name)
                    and not _CB_REGISTRATION.match(name)
                    and not (is_self and self.cls and name in
                             self.mod.methods.get(self.cls, ()))):
                self.summary.sites.append(_Site("callback", name,
                                                call.lineno, held))
                return
            if name in _BLOCKING_METHODS:
                self.summary.sites.append(_Site("blocking", name,
                                                call.lineno, held))
                return
            if name in ("acquire", "release", "set", "get", "append",
                        "record", "inc", "items", "values", "keys",
                        "pop", "clear", "update", "add", "discard"):
                return  # cheap/bookkeeping: never resolved
            # resolvable call: self.method() or typed-attr method
            if is_self and self.cls:
                self.summary.sites.append(_Site(
                    "call", f"{self.cls}.{name}", call.lineno, held))
            else:
                owner = self.col._recv_class(self.mod, self.cls, recv)
                if owner:
                    self.summary.sites.append(_Site(
                        "call", f"{owner}.{name}", call.lineno, held,
                        recv_attr=_dotted(recv)))
        elif isinstance(fn, ast.Name):
            if fn.id in self.cb_aliases or _CB_NAME.match(fn.id):
                self.summary.sites.append(_Site("callback", fn.id,
                                                call.lineno, held))

    @staticmethod
    def _open_writes(call: ast.Call) -> bool:
        mode = None
        if len(call.args) >= 2 and isinstance(call.args[1],
                                              ast.Constant):
            mode = call.args[1].value
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        return isinstance(mode, str) and bool(_WRITE_MODE.search(mode))


# ----------------------------------------------------------------------
# analysis over the collected summaries


class ConcurAnalysis:
    """One collection pass; the three checks and the graph share it."""

    def __init__(self, root: str):
        self.root = root
        self.col = _Collector(root)
        self.col.collect()

    # -- lookup --------------------------------------------------------

    def _fn(self, qname: str) -> _FnSummary | None:
        cls = qname.split(".", 1)[0] if "." in qname else None
        if cls:
            home = self.col.class_home.get(cls)
            mod = self.col.modules.get(home) if home else None
            if mod:
                return mod.fns.get(qname)
            return None
        for mod in self.col.modules.values():
            if qname in mod.fns:
                return mod.fns[qname]
        return None

    def _lock_reentrant(self, q: str) -> bool:
        for mod in self.col.modules.values():
            if q in mod.locks:
                return mod.locks[q]
        return False

    # -- the lock-order graph ------------------------------------------

    def lock_edges(self) -> dict:
        """``{(src, dst): (relpath, line, via)}`` — first site wins."""
        edges: dict = {}

        def add(src, dst, rel, line, via=None):
            edges.setdefault((src, dst), (rel, line, via))

        for mod in self.col.modules.values():
            for summary in mod.fns.values():
                for s in summary.sites:
                    if s.kind == "acquire":
                        for h in s.held:
                            add(h, s.name, summary.relpath, s.line)
                    elif s.kind == "call" and s.held:
                        callee = self._fn(s.name)
                        if callee is None:
                            continue
                        for c in callee.direct("acquire"):
                            for h in s.held:
                                add(h, c.name, summary.relpath,
                                    s.line, via=s.name)
        return edges

    @staticmethod
    def _sccs(adj: dict) -> list[list[str]]:
        """Tarjan strongly-connected components (iterative) — every
        multi-node SCC contains at least one deadlock cycle, and
        every cycle lives inside exactly one SCC, so enumerating SCCs
        misses nothing (a plain DFS-from-each-start with visited
        pruning does: a b↔c inversion reachable only THROUGH a is
        pruned once a's exploration marks b and c seen)."""
        index: dict = {}
        low: dict = {}
        on_stack: set = set()
        stack: list = []
        sccs: list[list[str]] = []
        counter = [0]
        nodes = sorted(set(adj)
                       | {d for ds in adj.values() for d in ds})
        for root in nodes:
            if root in index:
                continue
            work = [(root, iter(adj.get(root, ())))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index:
                        index[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, iter(adj.get(nxt, ()))))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        n = stack.pop()
                        on_stack.discard(n)
                        scc.append(n)
                        if n == node:
                            break
                    sccs.append(scc)
        return sccs

    @staticmethod
    def _cycle_in(scc: set, adj: dict) -> list[str]:
        """One concrete cycle inside a multi-node SCC (DFS restricted
        to the SCC; guaranteed to exist by SCC-ness)."""
        start = sorted(scc)[0]
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt not in scc:
                    continue
                if nxt == start:
                    return path + [nxt]
                if nxt not in path:
                    stack.append((nxt, path + [nxt]))
        return [start, start]   # unreachable for a true SCC

    def check_lock_order(self) -> list[SelfFinding]:
        findings: list[SelfFinding] = []
        edges = self.lock_edges()
        # one-node cycles: re-acquiring a non-reentrant lock
        adj: dict = {}
        for (src, dst), (rel, line, via) in sorted(edges.items()):
            if src == dst:
                if not self._lock_reentrant(src):
                    findings.append(SelfFinding(
                        rel, line, "lock-order",
                        f"{src} is acquired while already held"
                        + (f" (via {via})" if via else "")
                        + " — a non-reentrant Lock self-deadlocks "
                          "here; use an RLock or restructure"))
                continue
            adj.setdefault(src, []).append(dst)
        # multi-node cycles: one finding per strongly-connected
        # component, with a concrete representative cycle.
        for scc in self._sccs(adj):
            if len(scc) < 2:
                continue
            cycle = self._cycle_in(set(scc), adj)
            sites = " ; ".join(
                f"{a}→{b} at "
                f"{edges[(a, b)][0]}:{edges[(a, b)][1]}"
                for a, b in zip(cycle, cycle[1:]))
            rel, line, _ = edges[(cycle[0], cycle[1])]
            findings.append(SelfFinding(
                rel, line, "lock-order",
                f"lock-order cycle {' → '.join(cycle)} — two "
                f"threads taking these locks in opposite order "
                f"deadlock ({sites})"
                + (f"; {len(scc)} locks are mutually entangled"
                   if len(scc) > len(cycle) - 1 else "")))
        return sorted(findings, key=lambda f: (f.file, f.line))

    def lock_graph_dot(self) -> str:
        """The acquires-while-holding graph as Graphviz dot —
        reviewable documentation of the framework's lock hierarchy."""
        edges = self.lock_edges()
        nodes = sorted({n for e in edges for n in e})
        out = ["digraph lock_order {",
               '  rankdir=LR;',
               '  node [shape=box, fontsize=10];',
               '  label="acquires-while-holding (nbd-torch-lint '
               '--lock-graph)";']
        for n in nodes:
            style = ', style=rounded' if self._lock_reentrant(n) else ''
            out.append(f'  "{n}" [label="{n}"{style}];')
        for (src, dst), (rel, line, via) in sorted(edges.items()):
            attrs = [f'label="{rel}:{line}"', 'fontsize=8']
            if src == dst and self._lock_reentrant(src):
                attrs.append("style=dashed")  # reentrant self-edge
            if via:
                attrs.append(f'tooltip="via {via}"')
            out.append(f'  "{src}" -> "{dst}" [{", ".join(attrs)}];')
        out.append("}")
        return "\n".join(out)

    # -- blocking under lock -------------------------------------------

    def _exempt(self, table: dict, fn_qname: str, name: str) -> bool:
        return f"{fn_qname}:{name}" in table

    def check_blocking_under_lock(self) -> list[SelfFinding]:
        findings: list[SelfFinding] = []
        for mod in self.col.modules.values():
            for summary in mod.fns.values():
                for s in summary.sites:
                    if s.kind == "blocking" and s.held:
                        self._flag_blocking(findings, mod, summary,
                                            s.name, s.line, s.held)
                    elif s.kind == "call" and s.held:
                        callee = self._fn(s.name)
                        if callee is None:
                            continue
                        for b in callee.direct("blocking"):
                            if b.held:
                                # The callee reports this site itself
                                # (its own lock, or a `_locked` entry
                                # lockset) — re-flagging it at every
                                # caller would count one defect k+1
                                # times.
                                continue
                            self._flag_blocking(
                                findings, mod, summary, b.name,
                                s.line, s.held, via=s.name)
        return sorted(findings, key=lambda f: (f.file, f.line))

    def _flag_blocking(self, findings, mod, summary, op, line, held,
                       via=None) -> None:
        if self._exempt(mod.blocking_ok, summary.qname, op):
            return
        if via is not None:
            # The callee's own module may exempt the op at its site
            # (`Class.method:op`), which covers every caller.
            callee = self._fn(via)
            if callee is not None:
                cmod = self.col.modules.get(callee.relpath)
                if cmod is not None and self._exempt(
                        cmod.blocking_ok, via, op):
                    return
        findings.append(SelfFinding(
            summary.relpath, line, "blocking-under-lock",
            f"{summary.qname}: blocking call {op!r}"
            + (f" (via {via})" if via else "")
            + f" reached while holding {', '.join(sorted(held))} — "
              f"move the IO outside the lock or exempt the site in "
              f"_LINT_BLOCKING_OK with a reason"))

    # -- callbacks under lock ------------------------------------------

    def check_callback_under_lock(self) -> list[SelfFinding]:
        findings: list[SelfFinding] = []
        for mod in self.col.modules.values():
            for summary in mod.fns.values():
                for s in summary.sites:
                    if s.kind == "callback" and s.held:
                        self._flag_callback(findings, mod, summary,
                                            s.name, s.line, s.held)
                    elif s.kind == "call" and s.held:
                        callee = self._fn(s.name)
                        if callee is None:
                            continue
                        for c in callee.direct("callback"):
                            if c.held:
                                continue  # self-reported by the callee
                            self._flag_callback(
                                findings, mod, summary, c.name,
                                s.line, s.held, via=s.name)
        return sorted(findings, key=lambda f: (f.file, f.line))

    def _flag_callback(self, findings, mod, summary, name, line, held,
                       via=None) -> None:
        if self._exempt(mod.callback_ok, summary.qname, name):
            return
        if via is not None:
            callee = self._fn(via)
            if callee is not None:
                cmod = self.col.modules.get(callee.relpath)
                if cmod is not None and self._exempt(
                        cmod.callback_ok, via, name):
                    return
        findings.append(SelfFinding(
            summary.relpath, line, "callback-under-lock",
            f"{summary.qname}: stored callback {name!r}"
            + (f" (via {via})" if via else "")
            + f" invoked while holding {', '.join(sorted(held))} — "
              f"the callback may re-enter this object and deadlock; "
              f"copy the callback under the lock, invoke it outside, "
              f"or exempt the site in _LINT_CALLBACK_OK with a "
              f"reason"))


# ----------------------------------------------------------------------
# entry points


def run_concur_lint(root: str, an: ConcurAnalysis | None = None
                    ) -> dict[str, list[SelfFinding]]:
    """The three concurrency passes; ``{pass_name: findings}``.
    ``an`` lets ``run_self_lint`` share one collection pass with the
    lifecycle passes instead of re-walking the tree."""
    an = an if an is not None else ConcurAnalysis(root)
    return {
        "lock-order": an.check_lock_order(),
        "blocking-under-lock": an.check_blocking_under_lock(),
        "callback-under-lock": an.check_callback_under_lock(),
    }


def lock_graph_dot(root: str) -> str:
    return ConcurAnalysis(root).lock_graph_dot()
