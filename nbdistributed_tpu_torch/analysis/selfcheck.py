"""Self-lint: custom AST passes over the port's own source (a copy
of ``nbdistributed_tpu/analysis/selfcheck.py``, pointed at
``nbdistributed_tpu_torch/``).

Run by ``tools/nbd_torch_lint.py --self``, ``%dist_lint self`` and the
port's lint tests.  Four registry/discipline passes live here, each
encoding a project invariant that used to live only in review
comments; :func:`run_self_lint` additionally folds in the three
:mod:`concur` concurrency passes (lock-order graph,
blocking-call-under-lock, callback-reentrancy) and the three
:mod:`lifecycle` passes:

1. **env-knob registry** (:func:`check_env_knobs`): every ``NBD_*``
   string in the product tree (``nbdistributed_tpu_torch/``,
   ``tools/nbd_torch_*.py``, ``chip_smoke.py``) must be declared in
   the port's ``utils/knobs.py`` and documented in README's
   configuration reference.

2. **codec wire-extension registry** (:func:`check_codec_headers`):
   the optional frame-header keys ``encode``/``decode`` handle and
   the heartbeat-ping piggyback fields the worker writes must match
   the port's ``messaging/codec.py`` ``WIRE_EXTENSIONS`` table
   exactly — declared-but-unused and used-but-undeclared both fail.

3. **thread-shared-state discipline**
   (:func:`check_thread_shared_state`): in classes that own a
   ``self._lock`` (coordinator, watchdog, supervisor, the gateway's
   daemon/registry/scheduler/serving manager, membership, router,
   autoscaler, the serving observatory, the training guard), every
   read-modify-write of ``self`` state (``+=``, container mutation)
   outside a ``with self._lock:`` block is a finding, unless the
   attribute is listed in the module's ``_LINT_SINGLE_WRITER``
   exemption table (the documented single-writer / thread-safe-
   container pattern).  Plain attribute rebinds are allowed — that is
   the documented atomic-replace pattern.  A method whose name ends
   in ``_locked`` ASSERTS its callers hold ``self._lock``: its body
   is treated as locked, and any call to a ``self.*_locked`` helper
   from an unlocked context is itself a finding.

4. **protocol handler coverage** (:func:`check_protocol_coverage`):
   per wire plane (coordinator→worker requests, worker→coordinator
   notices, tenant→gateway, gateway→tenant notices, manager→agent,
   agent→manager notices), every message-type literal a sender puts
   on the wire must have a registered handler on the receiving side,
   and every registered handler must have at least one product-tree
   sender — used-but-unhandled and handled-but-unsent both fail,
   with the ``_PROTOCOL_EXTERNAL`` exemption table for intentionally
   external types.

Every path the passes read is relative to :data:`_PKG`, the one
constant naming the package directory.  Stdlib-only; every finding
carries ``file:line``.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from dataclasses import dataclass

_NBD_FULL = re.compile(r"^NBD_[A-Z][A-Z0-9_]*$")

# The package directory every pass reads, relative to the repo root.
_PKG = "nbdistributed_tpu_torch"

# Product scan scope, relative to the repo root: the package, the
# port's tools (``tools/nbd_torch_*.py``; the rest of ``tools/`` is
# the JAX package's) and the chip script.  Tests and examples SET
# knobs but only the product tree READS them — declarations cover
# readers.
_PRODUCT_GLOBS = (("tools", "nbd_torch_*.py"),)
_PRODUCT_FILES = ("chip_smoke.py",)

# Container-constructor names recognized when classifying ``__init__``
# attributes for the thread pass.
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "OrderedDict",
                    "defaultdict", "Counter"}
_MUTATORS = {"append", "appendleft", "add", "update", "pop", "popleft",
             "popitem", "remove", "discard", "clear", "setdefault",
             "extend", "insert"}

# Modules of the thread pass, relative to the package directory: the
# coordinator, watchdog and supervisor; the gateway (daemon fields
# are shared between the tenant-plane listener thread, per-request
# serve threads and the eviction/manifest threads; the scheduler
# between every submitter; the serving manager's request table
# between submit threads and the decode driver; membership between
# the resize thread, the listener and the manifest writer; the router
# and autoscaler so their locking stays honest as they grow state);
# the serving observatory (its request table and util ring; perfbase
# rides the list so any future cache grows a lock); and the training
# guard (counters and snapshot ring mutated on the train-loop thread
# while the heartbeat thread reads the published snapshot).
_THREAD_CHECKED_FILES = (
    "messaging/coordinator.py",
    "resilience/watchdog.py",
    "resilience/supervisor.py",
    "gateway/daemon.py",
    "gateway/tenancy.py",
    "gateway/scheduler.py",
    "gateway/serving.py",
    "gateway/membership.py",
    "gateway/router.py",
    "resilience/autoscaler.py",
    "observability/servingobs.py",
    "observability/perfbase.py",
    "resilience/trainguard.py",
)


def _pkg_path(root: str, rel: str) -> str:
    """``rel`` (``/``-separated, within the package) under ``root``."""
    return os.path.join(root, _PKG, *rel.split("/"))


def _pkg_rel(rel: str) -> str:
    """``rel`` within the package as a repo-relative ``/`` path."""
    return f"{_PKG}/{rel}"


@dataclass
class SelfFinding:
    file: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def _iter_product_files(root: str):
    for dirpath, dirnames, filenames in os.walk(os.path.join(root,
                                                             _PKG)):
        dirnames[:] = [n for n in dirnames if n != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    for d, pattern in _PRODUCT_GLOBS:
        base = os.path.join(root, d)
        try:
            names = sorted(os.listdir(base))
        except OSError:
            continue
        for name in names:
            if fnmatch.fnmatch(name, pattern):
                yield os.path.join(base, name)
    for f in _PRODUCT_FILES:
        path = os.path.join(root, f)
        if os.path.exists(path):
            yield path


def _parse(path: str) -> ast.Module | None:
    try:
        with open(path, encoding="utf-8") as f:
            return ast.parse(f.read(), path)
    except (OSError, SyntaxError):
        return None


def _rel(root: str, path: str) -> str:
    return os.path.relpath(path, root)


# ----------------------------------------------------------------------
# pass 1: env-knob registry


def check_env_knobs(root: str, readme: str | None = None
                    ) -> list[SelfFinding]:
    from ..utils import knobs

    findings: list[SelfFinding] = []
    for path in _iter_product_files(root):
        tree = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            s = node.value
            if s.endswith("_") and s.startswith("NBD_"):
                # Dynamic composition prefix (f-string builders).
                if _NBD_FULL.match(s) and s not in knobs.PREFIXES:
                    findings.append(SelfFinding(
                        _rel(root, path), node.lineno, "env-knob",
                        f"dynamic knob prefix {s!r} is not declared "
                        f"in utils/knobs.py PREFIXES"))
                continue
            if _NBD_FULL.match(s) and s not in knobs.KNOBS:
                findings.append(SelfFinding(
                    _rel(root, path), node.lineno, "env-knob",
                    f"{s} is read/written here but not declared in "
                    f"utils/knobs.py — declare it (and document it "
                    f"in README's configuration reference)"))
    # README documentation check.
    readme_path = readme or os.path.join(root, "README.md")
    try:
        with open(readme_path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        text = ""
    for name in sorted(knobs.KNOBS):
        if not re.search(rf"\b{re.escape(name)}\b", text):
            findings.append(SelfFinding(
                "README.md", 0, "env-knob",
                f"declared knob {name} is not documented in README "
                f"(regenerate the table: nbd-lint --knob-table)"))
    return findings


# ----------------------------------------------------------------------
# pass 2: codec wire-extension registry


def _func(tree: ast.Module, name: str) -> ast.FunctionDef | None:
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _method(tree: ast.Module, cls: str, name: str
            ) -> ast.FunctionDef | None:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and sub.name == name:
                    return sub
    return None


def _subscript_str_key(node: ast.AST, varname: str) -> str | None:
    """``varname["key"]`` → "key"."""
    if (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id == varname
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)):
        return node.slice.value
    return None


def check_codec_headers(root: str) -> list[SelfFinding]:
    from ..messaging.codec import BASE_HEADER_KEYS, WIRE_EXTENSIONS

    findings: list[SelfFinding] = []
    declared_header = {k for k, v in WIRE_EXTENSIONS.items()
                       if v["plane"] == "header"}
    declared_ping = {k for k, v in WIRE_EXTENSIONS.items()
                     if v["plane"] == "ping"}

    codec_path = _pkg_path(root, "messaging/codec.py")
    tree = _parse(codec_path)
    if tree is None:
        return [SelfFinding(_pkg_rel("messaging/codec.py"), 0,
                            "codec-header", "could not parse codec.py")]
    rel_codec = _rel(root, codec_path)

    enc = _func(tree, "encode")
    emitted: set[str] = set()
    for node in ast.walk(enc) if enc else ():
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                key = _subscript_str_key(tgt, "header")
                if key is not None:
                    emitted.add(key)
    emitted -= set(BASE_HEADER_KEYS)

    dec = _func(tree, "decode")
    read: set[str] = set()
    for node in ast.walk(dec) if dec else ():
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "header"
                and node.args
                and isinstance(node.args[0], ast.Constant)):
            read.add(node.args[0].value)
    read -= set(BASE_HEADER_KEYS)

    for key in sorted(emitted - declared_header):
        findings.append(SelfFinding(
            rel_codec, enc.lineno, "codec-header",
            f"encode() emits optional header {key!r} not declared in "
            f"WIRE_EXTENSIONS"))
    for key in sorted(read - declared_header):
        findings.append(SelfFinding(
            rel_codec, dec.lineno, "codec-header",
            f"decode() reads optional header {key!r} not declared in "
            f"WIRE_EXTENSIONS"))
    for key in sorted(declared_header - emitted):
        findings.append(SelfFinding(
            rel_codec, enc.lineno if enc else 0, "codec-header",
            f"WIRE_EXTENSIONS declares header {key!r} but encode() "
            f"never emits it"))
    for key in sorted(declared_header - read):
        findings.append(SelfFinding(
            rel_codec, dec.lineno if dec else 0, "codec-header",
            f"WIRE_EXTENSIONS declares header {key!r} but decode() "
            f"never reads it"))

    # Ping plane: the worker heartbeat's data dict.
    worker_path = _pkg_path(root, "runtime/worker.py")
    wtree = _parse(worker_path)
    if wtree is None:
        findings.append(SelfFinding(
            _pkg_rel("runtime/worker.py"), 0, "codec-header",
            "could not parse worker.py"))
        return findings
    hb = None
    for node in ast.walk(wtree):
        if isinstance(node, ast.FunctionDef) and node.name == "_heartbeat":
            hb = node
            break
    written: set[str] = set()
    for node in ast.walk(hb) if hb else ():
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                key = _subscript_str_key(tgt, "data")
                if key is not None:
                    written.add(key)
                if isinstance(tgt, ast.Name) and tgt.id == "data" \
                        and isinstance(node.value, ast.Dict):
                    for k in node.value.keys:
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str):
                            written.add(k.value)
    rel_worker = _rel(root, worker_path)
    for key in sorted(written - declared_ping):
        findings.append(SelfFinding(
            rel_worker, hb.lineno if hb else 0, "codec-header",
            f"heartbeat piggybacks ping field {key!r} not declared in "
            f"WIRE_EXTENSIONS (plane 'ping')"))
    for key in sorted(declared_ping - written):
        findings.append(SelfFinding(
            rel_worker, hb.lineno if hb else 0, "codec-header",
            f"WIRE_EXTENSIONS declares ping field {key!r} but the "
            f"heartbeat never sends it"))
    return findings


# ----------------------------------------------------------------------
# pass 3: thread-shared-state discipline


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` → "X"."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _module_exemptions(tree: ast.Module) -> dict[str, str]:
    """Module-level ``_LINT_SINGLE_WRITER = {"Class.attr": "why"}``."""
    out: dict[str, str] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_LINT_SINGLE_WRITER"
                and isinstance(node.value, ast.Dict)):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) \
                        and isinstance(v, ast.Constant):
                    out[str(k.value)] = str(v.value)
    return out


class _ThreadPass(ast.NodeVisitor):
    def __init__(self, relpath: str, cls: str, containers: set[str],
                 exempt: dict[str, str], method: str = ""):
        self.relpath = relpath
        self.cls = cls
        self.containers = containers
        self.exempt = exempt
        # The `_locked` suffix asserts "caller holds self._lock":
        # the body is analyzed as locked, and unlocked CALLS to such
        # helpers are flagged below.
        self.locked = 1 if method.endswith("_locked") else 0
        self.findings: list[SelfFinding] = []

    def _is_exempt(self, attr: str) -> bool:
        return f"{self.cls}.{attr}" in self.exempt

    def _flag(self, node: ast.AST, attr: str, what: str) -> None:
        if self._is_exempt(attr):
            return
        self.findings.append(SelfFinding(
            self.relpath, node.lineno, "thread-shared-state",
            f"{self.cls}.{attr}: {what} outside `with self._lock:` — "
            f"use the lock, replace atomically (plain rebind), or "
            f"document the single-writer pattern in "
            f"_LINT_SINGLE_WRITER"))

    # -- lock tracking --------------------------------------------------

    def _with_takes_lock(self, node: ast.With) -> bool:
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and "lock" in attr:
                return True
        return False

    def visit_With(self, node: ast.With) -> None:
        if self._with_takes_lock(node):
            self.locked += 1
            self.generic_visit(node)
            self.locked -= 1
        else:
            self.generic_visit(node)

    # -- mutation patterns ----------------------------------------------

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is not None and not self.locked:
            self._flag(node, attr, "read-modify-write (`+=`)")
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        if not self.locked:
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    attr = _self_attr(tgt.value)
                    if attr is not None and attr in self.containers:
                        self._flag(node, attr, "container item write")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        if not self.locked:
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    attr = _self_attr(tgt.value)
                    if attr is not None and attr in self.containers:
                        self._flag(node, attr, "container item delete")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if not self.locked and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value)
            if attr is not None and attr in self.containers:
                self._flag(node, attr,
                           f"container mutation (.{node.func.attr})")
        if not self.locked and isinstance(node.func, ast.Attribute) \
                and node.func.attr.endswith("_locked") \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            self._flag(node, node.func.attr,
                       "call to a lock-asserting `*_locked` helper")
        self.generic_visit(node)


def check_thread_shared_state(root: str) -> list[SelfFinding]:
    findings: list[SelfFinding] = []
    for within in _THREAD_CHECKED_FILES:
        rel = _pkg_rel(within)
        path = _pkg_path(root, within)
        tree = _parse(path)
        if tree is None:
            continue
        exempt = _module_exemptions(tree)
        for node in tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            init = None
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) \
                        and sub.name == "__init__":
                    init = sub
                    break
            if init is None:
                continue
            has_lock = False
            containers: set[str] = set()
            for stmt in ast.walk(init):
                if isinstance(stmt, ast.Assign):
                    tgts = stmt.targets
                elif isinstance(stmt, ast.AnnAssign) \
                        and stmt.value is not None:
                    tgts = [stmt.target]
                else:
                    continue
                for tgt in tgts:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    if "lock" in attr:
                        has_lock = True
                    v = stmt.value
                    if isinstance(v, (ast.Dict, ast.List, ast.Set)):
                        containers.add(attr)
                    elif isinstance(v, ast.Call):
                        fn = v.func
                        ctor = (fn.id if isinstance(fn, ast.Name)
                                else fn.attr
                                if isinstance(fn, ast.Attribute)
                                else None)
                        if ctor in _CONTAINER_CTORS:
                            containers.add(attr)
            if not has_lock:
                continue
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) \
                        and sub.name != "__init__":
                    p = _ThreadPass(rel.replace(os.sep, "/"),
                                    node.name, containers, exempt,
                                    method=sub.name)
                    p.visit(sub)
                    findings.extend(p.findings)
    return findings


# ----------------------------------------------------------------------
# pass 4: protocol handler coverage
#
# Every message type a sender puts on a wire plane must have a
# registered handler on the receiving side, and every registered
# handler must have at least one sender — used-but-unhandled silently
# drops requests (the peer replies "unknown type" at best), and
# handled-but-unsent is dead protocol surface that rots.  Mirrors the
# WIRE_EXTENSIONS registry pass, directionally per plane.

# Intentionally external message types: sent or consumed outside the
# product tree (tests, operator probes) or implied by a default.
_PROTOCOL_EXTERNAL = {
    "worker-notice:response":
        "Message.reply()'s default msg_type — every worker handler "
        "reply carries it without a literal at the send site",
    "agent-notice:response":
        "Message.reply()'s default msg_type — every agent handler "
        "reply; the client correlates it by msg_id",
    "agent:ping":
        "agent liveness probe for tests and operators; sent from "
        "outside the product tree by design",
    "tenant-notice:response":
        "tenant_import reconstructs migrated parked results as "
        "mailbox entries — they leave the gateway only inside a "
        "mailbox drain's results dict, never as standalone frames",
}

# Sender-method msg_type positional index (after any leading
# ranks/rank argument).  ``submit`` is the non-blocking dispatch the
# bulk-transfer plane rides (xfer_chunk / xfer_read go out through it
# exclusively) — same (ranks, msg_type, ...) shape as send_to_ranks.
_SEND_METHODS = {"send_to_ranks": 1, "send_to_rank": 1, "post": 1,
                 "send_to_all": 0, "request": 0, "submit": 1}


def _rel_paths(root: str, rels) -> list[str]:
    return [os.path.join(root, *r.split("/")) for r in rels]


def _literal_arg(call: ast.Call, idx: int) -> str | None:
    if len(call.args) > idx and isinstance(call.args[idx], ast.Constant) \
            and isinstance(call.args[idx].value, str):
        return call.args[idx].value
    return None


def _sent_request_types(root: str, files=None, methods=None,
                        functions=None) -> dict[str, tuple[str, int]]:
    """``{msg_type: (relpath, line)}`` for literal-typed sender
    calls.  ``files=None`` scans the whole product tree;
    ``functions`` maps plain-function senders to their msg_type arg
    index (e.g. the tenant plane's ``_admin_request``)."""
    methods = methods if methods is not None else _SEND_METHODS
    functions = functions or {}
    out: dict[str, tuple[str, int]] = {}
    paths = (_rel_paths(root, files) if files is not None
             else list(_iter_product_files(root)))
    for path in paths:
        tree = _parse(path)
        if tree is None:
            continue
        rel = _rel(root, path).replace(os.sep, "/")
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in methods:
                t = _literal_arg(node, methods[fn.attr])
            elif isinstance(fn, ast.Name) and fn.id in functions:
                t = _literal_arg(node, functions[fn.id])
            else:
                continue
            if t is not None:
                out.setdefault(t, (rel, node.lineno))
    return out


def _constructed_types(root: str, file: str, cls: str | None = None
                       ) -> dict[str, tuple[str, int]]:
    """``Message(msg_type="X")`` / ``msg.reply(msg_type="X")`` /
    ``msg.reply("X")`` literals, optionally restricted to one class's
    body (sender and receiver classes share files)."""
    path = os.path.join(root, *file.split("/"))
    tree = _parse(path)
    out: dict[str, tuple[str, int]] = {}
    if tree is None:
        return out
    scope: ast.AST = tree
    if cls is not None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls:
                scope = node
                break
    for node in ast.walk(scope):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        t = None
        if isinstance(fn, ast.Name) and fn.id == "Message":
            for kw in node.keywords:
                if kw.arg == "msg_type" \
                        and isinstance(kw.value, ast.Constant):
                    t = kw.value.value
        elif isinstance(fn, ast.Attribute) and fn.attr == "reply":
            t = _literal_arg(node, 0)
            for kw in node.keywords:
                if kw.arg == "msg_type" \
                        and isinstance(kw.value, ast.Constant):
                    t = kw.value.value
        if isinstance(t, str):
            out.setdefault(t, (file, node.lineno))
    return out


def _handled_types(root: str, file: str, cls: str | None = None
                   ) -> dict[str, tuple[str, int]]:
    """Registered handler types in one receiver module: ``handlers =
    {"X": ...}`` dict literals, ``*.msg_type``/``mt``/``t`` equality
    and tuple-membership comparisons, and membership in module-level
    frozenset literals (``_PRE_HELLO``).  A bare ``msg_type``
    parameter is SENDER-side plumbing (``send_to_ranks(..., msg_type)``
    branches) and deliberately does not count.  ``cls`` restricts the
    scan to one class — the agent file holds both the server
    (``HostAgent``) and the client (``AgentClient``) dispatch."""
    path = os.path.join(root, *file.split("/"))
    tree = _parse(path)
    out: dict[str, tuple[str, int]] = {}
    if tree is None:
        return out
    rel = file

    # Module-level frozenset/set/tuple literals of strings, by name.
    named_sets: dict[str, list[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = node.value
            elts = None
            if isinstance(v, ast.Call) and isinstance(v.func, ast.Name) \
                    and v.func.id == "frozenset" and v.args \
                    and isinstance(v.args[0], (ast.Set, ast.Tuple,
                                               ast.List)):
                elts = v.args[0].elts
            elif isinstance(v, (ast.Set, ast.Tuple)):
                elts = v.elts
            if elts is not None:
                vals = [e.value for e in elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
                if vals:
                    named_sets[node.targets[0].id] = vals

    def _is_type_expr(e: ast.AST) -> bool:
        return ((isinstance(e, ast.Attribute) and e.attr == "msg_type")
                or (isinstance(e, ast.Name) and e.id in ("mt", "t")))

    scope: ast.AST = tree
    if cls is not None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls:
                scope = node
                break
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "handlers" \
                and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) \
                        and isinstance(k.value, str):
                    out.setdefault(k.value, (rel, k.lineno))
        elif isinstance(node, ast.Compare) and _is_type_expr(node.left):
            for op, cmp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.Eq,)) \
                        and isinstance(cmp, ast.Constant) \
                        and isinstance(cmp.value, str):
                    out.setdefault(cmp.value, (rel, node.lineno))
                elif isinstance(op, ast.In):
                    if isinstance(cmp, (ast.Tuple, ast.Set, ast.List)):
                        for e in cmp.elts:
                            if isinstance(e, ast.Constant) \
                                    and isinstance(e.value, str):
                                out.setdefault(e.value,
                                               (rel, node.lineno))
                    elif isinstance(cmp, ast.Name) \
                            and cmp.id in named_sets:
                        for v in named_sets[cmp.id]:
                            out.setdefault(v, (rel, node.lineno))
    return out


def _protocol_planes(root: str) -> list[dict]:
    """Each plane: sent-literal map + handled-type map.  Kept as a
    function (not a constant) so tests can point the collectors at a
    synthetic tree."""
    worker_rx = _pkg_rel("runtime/worker.py")
    coord_rx = _pkg_rel("messaging/coordinator.py")
    daemon_rx = _pkg_rel("gateway/daemon.py")
    client_rx = _pkg_rel("gateway/client.py")
    agent_rx = _pkg_rel("manager/hostagent.py")
    return [
        {"name": "worker",
         # ``submit`` is the non-blocking dispatch path: the bulk-
         # transfer plane's xfer_chunk/xfer_read frames go out through
         # it exclusively (messaging/xfer.py), never via send_to_*.
         "sent": _sent_request_types(
             root, methods={"send_to_ranks": 1, "send_to_rank": 1,
                            "send_to_all": 0, "post": 1, "submit": 1}),
         "handled": _handled_types(root, worker_rx)},
        {"name": "worker-notice",
         "sent": _constructed_types(root, worker_rx),
         "handled": _handled_types(root, coord_rx)},
        {"name": "tenant",
         # router.py is in the sender list: today it sends
         # only through client.py's admin helpers, but a direct send
         # added there later must not escape the coverage pass.
         "sent": _sent_request_types(
             root, files=[client_rx,
                          _pkg_rel("gateway/router.py")],
             methods={"request": 0},
             functions={"_admin_request": 3}),
         "handled": _handled_types(root, daemon_rx)},
        {"name": "tenant-notice",
         # The serving plane (gateway/serving.py) pushes its
         # serve_tokens/serve_done notices through the daemon's
         # delivery bridges — its constructed types are tenant-plane
         # notices exactly like the daemon's own.
         "sent": {**_constructed_types(root, daemon_rx,
                                       cls="GatewayDaemon"),
                  **_constructed_types(
                      root, _pkg_rel("gateway/serving.py"))},
         "handled": _handled_types(root, client_rx)},
        {"name": "agent",
         "sent": {**_sent_request_types(
                      root, files=[agent_rx,
                                   _pkg_rel("manager/process_manager.py")],
                      methods={"request": 0}),
                  **_constructed_types(root, agent_rx,
                                       cls="AgentClient")},
         "handled": _handled_types(root, agent_rx, cls="HostAgent")},
        {"name": "agent-notice",
         "sent": _constructed_types(root, agent_rx, cls="HostAgent"),
         "handled": _handled_types(root, agent_rx,
                                   cls="AgentClient")},
    ]


def check_protocol_coverage(root: str, planes=None,
                            external=None) -> list[SelfFinding]:
    planes = planes if planes is not None else _protocol_planes(root)
    external = external if external is not None else _PROTOCOL_EXTERNAL
    findings: list[SelfFinding] = []
    for plane in planes:
        name = plane["name"]
        sent, handled = plane["sent"], plane["handled"]
        notice = name.endswith("-notice")
        for t in sorted(set(sent) - set(handled)):
            if f"{name}:{t}" in external:
                continue
            rel, line = sent[t]
            findings.append(SelfFinding(
                rel, line, "protocol-coverage",
                f"[{name} plane] message type {t!r} is sent here but "
                f"no receiver handles it — register a handler or "
                f"exempt it in _PROTOCOL_EXTERNAL with a reason"))
        for t in sorted(set(handled) - set(sent)):
            if f"{name}:{t}" in external:
                continue
            rel, line = handled[t]
            kind = "notice" if notice else "request"
            findings.append(SelfFinding(
                rel, line, "protocol-coverage",
                f"[{name} plane] handler for {t!r} is registered "
                f"here but nothing in the product tree sends that "
                f"{kind} — dead protocol surface; remove it or "
                f"exempt it in _PROTOCOL_EXTERNAL with a reason"))
    return findings


# ----------------------------------------------------------------------


def run_self_lint(root: str) -> dict[str, list[SelfFinding]]:
    """All ten passes; ``{pass_name: findings}`` (empty = clean):
    the four registry/discipline passes here, the three
    :mod:`concur` concurrency passes (5–7), and the three
    :mod:`lifecycle` passes (8–10: resource-leak,
    bracket-discipline, shutdown-completeness).  None are
    skippable: the chip script and the lint tests gate on every key."""
    from .concur import ConcurAnalysis, run_concur_lint
    from .lifecycle import run_lifecycle_lint
    results = {
        "env-knobs": check_env_knobs(root),
        "codec-headers": check_codec_headers(root),
        "thread-shared-state": check_thread_shared_state(root),
        "protocol-coverage": check_protocol_coverage(root),
    }
    # One interprocedural collection pass, shared by the lock passes
    # and the lifecycle shutdown pass.
    an = ConcurAnalysis(root)
    results.update(run_concur_lint(root, an=an))
    results.update(run_lifecycle_lint(root, concur=an))
    return results
