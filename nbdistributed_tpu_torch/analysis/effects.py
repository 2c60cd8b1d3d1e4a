"""Cell effect inference: the read/write/collective footprint that
makes overlapping cells provably safe (counterpart of
``nbdistributed_tpu/analysis/effects.py``).

For one cell, :func:`infer_effects` returns an :class:`EffectReport`:

- **name footprint** — free names the cell *reads*, names it *binds*
  at module scope (``writes``), object-*mutation* targets
  (``x.attr = …``, ``x[k] = …``, known mutator methods like
  ``x.append(...)``), and ``del``-ed names — including ``global``
  escapes out of function bodies and augmented assigns (read+write).
  Dynamic namespace escapes (``exec``/``eval``, star-imports,
  ``globals()``/``vars()``/``locals()`` writes, unparseable source)
  yield an explicit ``opaque`` verdict that conservatively poisons the
  whole namespace: an opaque cell depends on everything and everything
  after it depends on it.

- **collective footprint** — the *ordered* sequence of collective call
  sites the cell can reach from module level, with a three-way
  verdict: ``"none"`` (proven collective-free), ``"exact"`` (the
  sites are statically enumerable, in order), or ``"unknown"``
  (collectives may hide behind calls the analyzer cannot see
  through).  Calls into same-cell ``def``\\ s are resolved **one level
  deep**; anything deeper, any call into a user/framework function the
  analyzer cannot vet, and any host-sync call on a tensor
  (``.item()``, ``.cpu()``) records a *taint* and degrades the verdict
  to ``unknown`` — never to a false "free".  Calls whose root is
  provably inert (builtins, pure stdlib modules, ``numpy``, ``torch``
  outside its distributed packages) stay safe, so ordinary compute
  cells can be *proven* free rather than merely assumed.

- **host-sync / purity flags** — the cellcheck host-sync-in-loop
  detection (``.item()``/``.tolist()``/``.cpu()``/
  ``torch.cuda.synchronize()``/printing computed values inside a loop)
  plus a cell-wide ``host_sync`` flag and a ``pure`` property (touches
  no names, no collectives, no host syncs, not opaque).

Consumers: the async in-flight window (``messaging/pipeline.py``: only
*proven*-free cells may overlap a collective-bearing cell; unknown or
opaque cells serialize with a reason) and the preflight store's
per-session cell dependency DAG (``%dist_lint deps``).

**The torch vocabulary** (the rest is the JAX package's walk, line for
line).  ``torch`` is a safe module root except under
``torch.distributed``, ``torch.nn.parallel`` (its
``DistributedDataParallel`` broadcasts at construction) and
``torch.cuda.nccl``: without that, every ``torch.randn(...)`` cell
would be ``unknown`` and no torch cell could ever overlap another.
Every ``torch.*`` module (``torch.nn.functional as F``) is safe by the
same rule, where the JAX package names its safe modules one by one.
The collective sites follow :func:`~.cellcheck.collective_op`
(``logits.gather`` is compute); host syncs are ``.item()``,
``.tolist()``, ``.cpu()`` and ``.synchronize()``.  The host-sync taint
stays as conservative as JAX's: a port tensor is rank-local, so its
``.item()`` never gathers, but proving that would be a new feature.

Stdlib-only (ast + builtins), shares the collective vocabulary and the
IPython stripping with :mod:`cellcheck` / :mod:`ipycompat`, and never
raises: source the analyzer cannot read comes back opaque.
"""

from __future__ import annotations

import ast
import builtins
from dataclasses import dataclass, field

from .cellcheck import HOST_SYNC_ATTRS, collective_op
from .ipycompat import non_python_cell_magic, strip_ipython

_BUILTIN_NAMES = frozenset(dir(builtins))

# Modules that can never reach a collective: pure stdlib, numpy
# (host-only) and torch (device compute) — torch minus
# UNSAFE_MODULES, where the collectives and their wrappers live.
SAFE_MODULES = frozenset({
    "time", "math", "os", "sys", "json", "re", "random", "itertools",
    "functools", "collections", "statistics", "string", "textwrap",
    "pathlib", "dataclasses", "typing", "heapq", "bisect", "copy",
    "pprint", "numpy", "torch",
})
UNSAFE_MODULES = ("torch.distributed", "torch.nn.parallel",
                  "torch.cuda.nccl")

# Ambient names assumed to denote those modules when the cell does not
# bind them itself (the worker seeds np/torch; time/math/os/... are the
# idiomatic stdlib spellings).  A cell that REBINDS one of these to
# anything that is not a safe import loses the assumption.
SAFE_CALL_ROOTS = frozenset(
    {m for m in SAFE_MODULES if "." not in m} | {"np", "torch"})
_ROOT_MODULE = {"np": "numpy"}


def _unsafe_module(path: str) -> bool:
    return any(path == u or path.startswith(u + ".")
               for u in UNSAFE_MODULES)


def _module_safe(path: str) -> bool:
    """A module whose every function is inert: a listed one, or any
    ``torch.*`` module outside ``UNSAFE_MODULES``."""
    if not path or _unsafe_module(path):
        return False
    return path in SAFE_MODULES or path.split(".")[0] == "torch"


def _chain_attrs(node: ast.AST) -> list[str]:
    """The attribute names along a call chain, root first
    (``torch.cuda.synchronize`` → ``["cuda", "synchronize"]``;
    ``torch.ones(2).sum`` → ``["ones", "sum"]``)."""
    out = []
    while True:
        if isinstance(node, ast.Attribute):
            out.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return out[::-1]


# Reading globals()/vars()/locals() is fine; WRITING through them is a
# dynamic namespace escape the static footprint cannot see.
_DYNAMIC_NS = frozenset({"globals", "vars", "locals"})
_NS_WRITE_METHODS = frozenset({"update", "setdefault", "pop",
                               "popitem", "clear"})

# Method names that mutate their receiver in place — conservative
# extras for the mutation footprint (same family the self-lint's
# thread pass recognizes).
_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "update", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "setdefault", "extend",
    "insert", "sort", "reverse",
})

# Builtin decorators that provably never INVOKE the function they
# wrap at application time (they build descriptors around it).
_NON_INVOKING_DECORATORS = frozenset({
    "staticmethod", "classmethod", "property",
})

_MAX_TAINTS = 8

VERDICT_NONE = "none"
VERDICT_EXACT = "exact"
VERDICT_UNKNOWN = "unknown"


@dataclass
class CollectiveSite:
    """One statically-visible collective call site."""

    op: str
    line: int
    in_loop: bool = False
    conditional: bool = False
    via: str | None = None   # reached through this same-cell def

    def as_dict(self) -> dict:
        d = {"op": self.op, "line": self.line}
        if self.in_loop:
            d["in_loop"] = True
        if self.conditional:
            d["conditional"] = True
        if self.via:
            d["via"] = self.via
        return d

    def render(self) -> str:
        out = f"{self.op}@L{self.line}"
        if self.via:
            out += f" (via {self.via})"
        flags = [f for f, on in (("loop", self.in_loop),
                                 ("cond", self.conditional)) if on]
        if flags:
            out += f" [{','.join(flags)}]"
        return out


@dataclass
class EffectReport:
    """Everything the scheduler and the dependency DAG need to know
    about one cell without running it."""

    parsed: bool = True
    opaque: bool = False
    opaque_reasons: tuple = ()
    reads: frozenset = frozenset()      # free names read
    writes: frozenset = frozenset()     # names bound at module scope
    mutates: frozenset = frozenset()    # objects mutated in place
    deletes: frozenset = frozenset()    # names del-ed at module scope
    collectives: tuple = ()             # ordered CollectiveSites
    collective_verdict: str = VERDICT_UNKNOWN
    taints: tuple = ()                  # why the verdict is unknown
    host_sync: bool = False
    host_sync_in_loop: bool = False
    # Ambient names this cell RE-ARMED by importing the real module
    # (`import numpy as np`): excluded from ambient_poison().
    safe_rearms: frozenset = frozenset()

    @property
    def touched(self) -> frozenset:
        """Names a later cell could observe a change to — the write
        side of the dependency DAG's write-read edges."""
        return self.writes | self.mutates | self.deletes

    @property
    def collective_free(self) -> bool:
        """PROVEN free — the only verdict that may overlap a running
        collective-bearing cell under effects admission."""
        return (self.parsed and not self.opaque
                and self.collective_verdict == VERDICT_NONE)

    @property
    def pure(self) -> bool:
        """Namespace-pure and mesh-silent: safe to reorder freely."""
        return (self.parsed and not self.opaque and not self.touched
                and self.collective_verdict == VERDICT_NONE
                and not self.host_sync)

    def as_dict(self) -> dict:
        """JSON-safe summary (the preflight store's entry shape)."""
        return {
            "parsed": self.parsed,
            "opaque": self.opaque,
            "opaque_reasons": list(self.opaque_reasons),
            "reads": sorted(self.reads),
            "writes": sorted(self.writes),
            "mutates": sorted(self.mutates),
            "deletes": sorted(self.deletes),
            "collectives": [s.as_dict() for s in self.collectives],
            "collective_verdict": self.collective_verdict,
            "taints": list(self.taints),
            "host_sync": self.host_sync,
            "host_sync_in_loop": self.host_sync_in_loop,
            "pure": self.pure,
        }


def collective_class(report: EffectReport | None) -> str:
    """The scheduler's three-way admission class for one cell:
    ``"free"`` (proven collective-free — may overlap anything),
    ``"bearing"`` (proven collective sites — must run alone among
    non-free cells), ``"unknown"`` (opaque/tainted — treated like
    bearing, with the verdict naming the uncertainty)."""
    if report is None or not report.parsed or report.opaque:
        return "unknown"
    if report.collective_verdict == VERDICT_NONE:
        return "free"
    if report.collective_verdict == VERDICT_EXACT:
        return "bearing"
    return "unknown"


# ----------------------------------------------------------------------


def _base_name(node: ast.AST) -> str | None:
    """The root Name of an attribute/call chain:
    ``torch.ones(2).sum`` → ``torch``; non-name bases → None."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def _param_names(args: ast.arguments) -> set[str]:
    """Every parameter name an ast.arguments node binds."""
    names = {a.arg for a in (args.args + args.posonlyargs
                             + args.kwonlyargs)}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names


def _pattern_names(pattern: ast.AST) -> list[str]:
    """Capture names bound by a match-case pattern."""
    out = []
    for sub in ast.walk(pattern):
        if isinstance(sub, (ast.MatchAs, ast.MatchStar)) \
                and sub.name is not None:
            out.append(sub.name)
        elif isinstance(sub, ast.MatchMapping) \
                and sub.rest is not None:
            out.append(sub.rest)
    return out


def _binding_targets(node: ast.AST):
    """(target names, value) for the single-value binding forms —
    Assign, AnnAssign, walrus — or ([], None)."""
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets
                if isinstance(t, ast.Name)], node.value
    if isinstance(node, ast.AnnAssign) and node.value is not None \
            and isinstance(node.target, ast.Name):
        return [node.target.id], node.value
    if isinstance(node, ast.NamedExpr) \
            and isinstance(node.target, ast.Name):
        return [node.target.id], node.value
    return [], None


def _collect_def_names(tree: ast.AST) -> frozenset:
    """Every function-object name the cell could create — def names
    (anywhere but class bodies, whose methods are not module names),
    lambda bindings (assign / annotated assign / walrus), and plain
    ALIASES of any of those (`g = step`), to a fixpoint.  This is the
    conservative net for the argument-escape scan: a name in this set
    passed as a call argument is a function the callee may invoke."""
    names: set[str] = set()

    def scan(node: ast.AST, aliases: bool) -> bool:
        changed = False
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                continue
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                if child.name not in names:
                    names.add(child.name)
                    changed = True
            else:
                tgts, value = _binding_targets(child)
                if tgts and (isinstance(value, ast.Lambda)
                             or (aliases and isinstance(value,
                                                        ast.Name)
                                 and value.id in names)):
                    for t in tgts:
                        if t not in names:
                            names.add(t)
                            changed = True
            if scan(child, aliases):
                changed = True
        return changed

    scan(tree, aliases=False)
    while scan(tree, aliases=True):
        pass
    return frozenset(names)


class _Walker:
    """One ordered pass over the module: name footprint, collective
    footprint, host-sync flags, opacity — all in source order."""

    def __init__(self, assume_unsafe: frozenset = frozenset()):
        self.reads: set[str] = set()
        self.writes: set[str] = set()
        self.mutates: set[str] = set()
        self.deletes: set[str] = set()
        self.bound: set[str] = set()      # bound so far at module scope
        self.sites: list[CollectiveSite] = []
        self.taints: list[str] = []
        self.opaque_reasons: list[str] = []
        self.host_sync = False
        self.host_sync_in_loop = False
        # Defs (and lambda-assigns) whose statement has EXECUTED in
        # the source-order walk: only these are resolvable — a call
        # before its `def` invokes whatever the name is bound to at
        # that point, not the later body.
        self.defs: dict[str, ast.AST] = {}
        # Every def name appearing ANYWHERE in the cell (conditional
        # branches, later lines, nested) — the conservative net for
        # the argument-escape scan.
        self._def_names: frozenset = frozenset()
        # Def names whose escape-check is in progress (bounds the
        # recursion of mutually-passing defs).
        self._escape_stack: set[str] = set()
        # False inside class bodies and resolved function bodies:
        # defs there do not bind resolvable module names.
        self._module_scope = True
        # Ambient names an EARLIER cell in this session rebound/
        # mutated/deleted: the per-cell assumption that `np`/`time`/
        # builtins denote their modules no longer holds for them.
        self._assume_unsafe = frozenset(assume_unsafe)
        # Names currently assumed to denote collective-free modules;
        # a safe import adds, any other rebind removes.
        self._safe_names: set[str] = (set(SAFE_CALL_ROOTS)
                                      - self._assume_unsafe)
        # The module each safe name denotes (``np`` → numpy,
        # ``F`` → torch.nn.functional): an attribute chain through
        # it is inert unless the full path enters UNSAFE_MODULES.
        self._safe_paths: dict[str, str] = {
            n: _ROOT_MODULE.get(n, n) for n in self._safe_names}
        # from-imports of a safe module's attribute (`from math import
        # sqrt`): safe as bare Name calls.
        self._safe_callables: set[str] = set()
        # Def names later rebound to something else: calling them is
        # no longer provably the same-cell def.
        self._rebound_defs: set[str] = set()
        # Ambient names this cell re-bound to their REAL modules —
        # a rebind that restores the assumption instead of breaking it.
        self._rearmed: set[str] = set()
        # One-level def resolution depth (recursion guard: a def that
        # calls itself — or another def — must taint, not recurse).
        self._depth = 0

    # -- small helpers --------------------------------------------------

    def _read(self, name: str) -> None:
        if name not in self.bound:
            self.reads.add(name)

    def _bind(self, name: str) -> None:
        if name in self.defs and name in self.bound:
            self._rebound_defs.add(name)
        self._safe_names.discard(name)
        self._safe_paths.pop(name, None)
        self._safe_callables.discard(name)
        self._rearmed.discard(name)
        self.writes.add(name)
        self.bound.add(name)

    def _taint(self, why: str) -> None:
        # Deduped: a nested call's argument subtree is re-walked by
        # the enclosing call's escape scan.
        if why not in self.taints and len(self.taints) < _MAX_TAINTS:
            self.taints.append(why)

    def _register_fn_binding(self, node: ast.AST, *, loop: int,
                             cond: int) -> None:
        """`g = lambda x: …` (assign / annotated / walrus) and plain
        ALIASES of a resolvable function (`g = step`) are same-cell
        function definitions: resolvable at later calls and
        escape-checkable as arguments, under the same scope/order
        rules as a def."""
        if not (self._module_scope and loop == 0 and cond == 0):
            return
        tgts, value = _binding_targets(node)
        if isinstance(value, ast.Lambda):
            fn: ast.AST | None = value
        elif isinstance(value, ast.Name) and value.id in self.defs \
                and value.id not in self._rebound_defs:
            fn = self.defs[value.id]
        else:
            fn = None
        if fn is None:
            return
        for t in tgts:
            self.defs[t] = fn
            self._rebound_defs.discard(t)

    def _opaque(self, why: str) -> None:
        if why not in self.opaque_reasons:
            self.opaque_reasons.append(why)

    def _collective_op(self, fn: ast.AST) -> str | None:
        return collective_op(fn)

    def _safe_module_name(self, name: str, module: str) -> None:
        self._safe_names.add(name)
        self._safe_paths[name] = module

    def _inert_chain(self, fn: ast.AST) -> bool:
        """An attribute chain rooted in a safe module name whose full
        dotted path stays out of UNSAFE_MODULES
        (``torch.nn.functional.relu``: inert;
        ``torch.distributed.new_group``: not)."""
        base = _base_name(fn)
        if base is None or base not in self._safe_names:
            return False
        path = ".".join([self._safe_paths.get(base, base)]
                        + _chain_attrs(fn))
        return not _unsafe_module(path)

    # -- module entry ---------------------------------------------------

    def run(self, tree: ast.Module) -> None:
        self._def_names = _collect_def_names(tree)
        self._scan_opacity(tree)
        self._block(tree.body, loop=0, cond=0)

    def _scan_opacity(self, tree: ast.Module) -> None:
        """Whole-tree sweep for dynamic namespace escapes — anywhere
        in the cell, including def bodies (a def is one call away)."""
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in ("exec", "eval"):
                self._opaque(f"{node.func.id}() at L{node.lineno} — "
                             "dynamic code can touch any name")
            elif isinstance(node, ast.ImportFrom) \
                    and any(a.name == "*" for a in node.names):
                self._opaque(f"star-import at L{node.lineno} binds an "
                             "unknowable set of names")
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name) \
                    and node.value.func.id in _DYNAMIC_NS:
                self._opaque(
                    f"{node.value.func.id}()[...] write at "
                    f"L{node.lineno} escapes the static footprint")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _NS_WRITE_METHODS \
                    and isinstance(node.func.value, ast.Call) \
                    and isinstance(node.func.value.func, ast.Name) \
                    and node.func.value.func.id in _DYNAMIC_NS:
                self._opaque(
                    f"{node.func.value.func.id}()."
                    f"{node.func.attr}(...) at L{node.lineno} escapes "
                    "the static footprint")

    # -- statements (source order) --------------------------------------

    def _block(self, stmts, *, loop: int, cond: int) -> None:
        for st in stmts:
            self._stmt(st, loop=loop, cond=cond)

    def _stmt(self, st: ast.stmt, *, loop: int, cond: int) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in (list(st.args.defaults)
                      + [d for d in st.args.kw_defaults
                         if d is not None]):
                self._expr(d, loop=loop, cond=cond)
            self._bind(st.name)
            # Resolvable only from here on, and only when the def
            # statement EXECUTES unconditionally at module scope — a
            # def inside an if/for arm leaves the name's binding
            # statically ambiguous, so calls to it must not resolve
            # this body.
            if self._module_scope and loop == 0 and cond == 0:
                self.defs[st.name] = st
                self._rebound_defs.discard(st.name)
            self._def_name_footprint(st)
            # Decorator application CALLS the decorator with the
            # just-created function at definition time.
            for dec in st.decorator_list:
                self._decorator(dec, st, loop=loop, cond=cond)
            return
        if isinstance(st, ast.ClassDef):
            for dec in st.decorator_list:
                self._class_decorator(dec, st, loop=loop, cond=cond)
            for b in st.bases:
                self._expr(b, loop=loop, cond=cond)
            # The class body EXECUTES at definition time (its calls are
            # reachable) but binds class attributes, not module names:
            # route the walk through a bind-sink.
            saved_bind, self._bind = self._bind, lambda name: None
            saved_scope, self._module_scope = self._module_scope, False
            try:
                self._block(st.body, loop=loop, cond=cond)
            finally:
                self._bind = saved_bind
                self._module_scope = saved_scope
            self._bind(st.name)
            return
        if isinstance(st, ast.If):
            self._expr(st.test, loop=loop, cond=cond)
            self._block(st.body, loop=loop, cond=cond + 1)
            self._block(st.orelse, loop=loop, cond=cond + 1)
            return
        if isinstance(st, ast.While):
            self._expr(st.test, loop=loop, cond=cond)
            self._block(st.body, loop=loop + 1, cond=cond + 1)
            self._block(st.orelse, loop=loop, cond=cond + 1)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter, loop=loop, cond=cond)
            self._target(st.target)
            self._block(st.body, loop=loop + 1, cond=cond)
            self._block(st.orelse, loop=loop, cond=cond)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr, loop=loop, cond=cond)
                if item.optional_vars is not None:
                    self._target(item.optional_vars)
            self._block(st.body, loop=loop, cond=cond)
            return
        if isinstance(st, ast.Try):
            self._block(st.body, loop=loop, cond=cond)
            for h in st.handlers:
                if h.type is not None:
                    self._expr(h.type, loop=loop, cond=cond)
                if h.name:
                    self._bind(h.name)
                self._block(h.body, loop=loop, cond=cond + 1)
            self._block(st.orelse, loop=loop, cond=cond)
            self._block(st.finalbody, loop=loop, cond=cond)
            return
        if isinstance(st, ast.Match):
            self._expr(st.subject, loop=loop, cond=cond)
            for case in st.cases:
                for name in _pattern_names(case.pattern):
                    self._bind(name)
                if case.guard is not None:
                    self._expr(case.guard, loop=loop, cond=cond)
                self._block(case.body, loop=loop, cond=cond + 1)
            return
        if isinstance(st, ast.Assign):
            self._expr(st.value, loop=loop, cond=cond)
            for tgt in st.targets:
                self._target(tgt)
            self._register_fn_binding(st, loop=loop, cond=cond)
            return
        if isinstance(st, ast.AugAssign):
            self._expr(st.value, loop=loop, cond=cond)
            if isinstance(st.target, ast.Name):
                self._read(st.target.id)   # read-modify-write
                self._bind(st.target.id)
            else:
                self._target(st.target)
            return
        if isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._expr(st.value, loop=loop, cond=cond)
                self._target(st.target)
                self._register_fn_binding(st, loop=loop, cond=cond)
            return
        if isinstance(st, ast.Delete):
            for tgt in st.targets:
                if isinstance(tgt, ast.Name):
                    self.deletes.add(tgt.id)
                    # A deleted name is free again for later reads.
                    self.bound.discard(tgt.id)
                elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    base = _base_name(tgt)
                    if base is not None:
                        self._read(base)
                        self.mutates.add(base)
                    self._expr(tgt, loop=loop, cond=cond)
            return
        if isinstance(st, ast.Import):
            for alias in st.names:
                bound = alias.asname or alias.name.split(".")[0]
                self._bind(bound)
                # `import numpy as np` re-arms np as a safe root;
                # `import torch.distributed as np` disarms it (handled
                # by _bind).
                module = (alias.name if alias.asname
                          else alias.name.split(".")[0])
                if _module_safe(module):
                    self._safe_module_name(bound, module)
                    self._rearmed.add(bound)
            return
        if isinstance(st, ast.ImportFrom):
            for alias in st.names:
                if alias.name == "*":
                    continue      # opacity pass already flagged it
                bound = alias.asname or alias.name
                self._bind(bound)
                mod = st.module or ""
                full = f"{mod}.{alias.name}"
                if _module_safe(mod) and not _unsafe_module(full):
                    # `from math import sqrt`: sqrt() is as inert as
                    # math.sqrt().  `from torch.nn import functional
                    # as F`: the ATTR itself is a safe module — and a
                    # torch attribute may be either, so it is both.
                    if _module_safe(full):
                        self._safe_module_name(bound, full)
                    if full not in SAFE_MODULES:
                        self._safe_callables.add(bound)
                    self._rearmed.add(bound)
            return
        if isinstance(st, ast.Global):
            # Module-level `global` is a no-op; the def walker handles
            # the in-function case.
            return
        if isinstance(st, (ast.Return, ast.Raise)):
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._expr(child, loop=loop, cond=cond)
            return
        if isinstance(st, ast.Expr):
            self._expr(st.value, loop=loop, cond=cond)
            return
        # Pass/Break/Continue/Nonlocal/etc.: walk any expressions.
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child, loop=loop, cond=cond)

    def _target(self, tgt: ast.AST) -> None:
        """An assignment/for/with target: Names bind the module
        namespace; attribute/subscript targets mutate the base
        object (and read its name)."""
        if isinstance(tgt, ast.Name):
            self._bind(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._target(el)
        elif isinstance(tgt, ast.Starred):
            self._target(tgt.value)
        elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
            base = _base_name(tgt)
            if base is not None:
                self._read(base)
                self.mutates.add(base)
            # Subscript index / attribute chain still reads names.
            for sub in ast.walk(tgt):
                if isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Load):
                    self._read(sub.id)

    # -- expressions ----------------------------------------------------

    def _expr(self, expr: ast.expr, *, loop: int, cond: int,
              via: str | None = None, depth: int = 0) -> None:
        """In-order expression walk: reads, walrus binds, nested defs
        (lambda/comprehension scopes), and call classification."""
        if expr is None:
            return
        if isinstance(expr, ast.Name):
            if isinstance(expr.ctx, ast.Load):
                self._read(expr.id)
            return
        if isinstance(expr, ast.NamedExpr):
            self._expr(expr.value, loop=loop, cond=cond, via=via,
                       depth=depth)
            if isinstance(expr.target, ast.Name):
                self._bind(expr.target.id)
                self._register_fn_binding(expr, loop=loop, cond=cond)
            return
        if isinstance(expr, ast.Lambda):
            # Body runs at call time; free names still count as reads
            # (conservative), but its calls are classified only when
            # the lambda is called — which the classifier taints.
            self._lambda_reads(expr)
            return
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            # Comprehensions are their own scope (py3): iteration
            # targets are not module binds; a host-sync inside one IS
            # a loop-shaped host sync.
            self._comp(expr, loop=loop, cond=cond, via=via,
                       depth=depth)
            return
        if isinstance(expr, ast.Call):
            self._call(expr, loop=loop, cond=cond, via=via,
                       depth=depth)
            return
        if isinstance(expr, ast.IfExp):
            self._expr(expr.test, loop=loop, cond=cond, via=via,
                       depth=depth)
            self._expr(expr.body, loop=loop, cond=cond + 1, via=via,
                       depth=depth)
            self._expr(expr.orelse, loop=loop, cond=cond + 1, via=via,
                       depth=depth)
            return
        if isinstance(expr, ast.Await):
            self._expr(expr.value, loop=loop, cond=cond, via=via,
                       depth=depth)
            return
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                self._expr(child, loop=loop, cond=cond, via=via,
                           depth=depth)

    def _comp(self, comp, *, loop: int, cond: int, via, depth) -> None:
        local = set()
        for gen in comp.generators:
            for sub in ast.walk(gen.target):
                if isinstance(sub, ast.Name):
                    local.add(sub.id)
        saved = self.bound
        self.bound = saved | local
        try:
            for gen in comp.generators:
                self._expr(gen.iter, loop=loop, cond=cond, via=via,
                           depth=depth)
                for cnd in gen.ifs:
                    self._expr(cnd, loop=loop + 1, cond=cond + 1,
                               via=via, depth=depth)
            if isinstance(comp, ast.DictComp):
                self._expr(comp.key, loop=loop + 1, cond=cond,
                           via=via, depth=depth)
                self._expr(comp.value, loop=loop + 1, cond=cond,
                           via=via, depth=depth)
            else:
                self._expr(comp.elt, loop=loop + 1, cond=cond,
                           via=via, depth=depth)
        finally:
            self.bound = saved

    def _lambda_reads(self, lam: ast.Lambda) -> None:
        params = _param_names(lam.args)
        for sub in ast.walk(lam.body):
            if isinstance(sub, ast.Name) \
                    and isinstance(sub.ctx, ast.Load) \
                    and sub.id not in params:
                self._read(sub.id)

    # -- call classification --------------------------------------------

    def _call(self, call: ast.Call, *, loop: int, cond: int,
              via: str | None, depth: int) -> None:
        # Arguments first (they evaluate before the call).
        for a in call.args:
            self._expr(a, loop=loop, cond=cond, via=via, depth=depth)
        for kw in call.keywords:
            self._expr(kw.value, loop=loop, cond=cond, via=via,
                       depth=depth)
        # A function object among the arguments ESCAPES into the
        # callee, which may invoke it any number of times — its
        # collectives would run without a visible site here
        # (`list(map(step, data))`, `sorted(xs, key=fn)`).
        self._escape_args(call)
        fn = call.func
        op = self._collective_op(fn)
        if op is not None:
            # The shadow check: `all_reduce = my_fn` earlier makes the
            # name a user function, not the framework collective — but
            # the conservative direction is to still record the SITE
            # (a shadowed collective is at best unknown).
            self.sites.append(CollectiveSite(
                op=op, line=call.lineno, in_loop=loop > 0,
                conditional=cond > 0, via=via))
            if isinstance(fn, ast.Name):
                self._read(fn.id)
            else:
                self._expr(fn, loop=loop, cond=cond, via=via,
                           depth=depth)
            return
        if isinstance(fn, ast.Name):
            self._read(fn.id)
            name = fn.id
            # Only defs whose STATEMENT already executed in the walk
            # resolve (self.defs is populated in source order): in
            # `f = g; f(); def f(): …` the call invokes the earlier
            # binding, so it falls through to the generic rules below
            # instead of borrowing the later body's proof.
            if name in self.defs and name not in self._rebound_defs:
                if self._depth == 0:
                    self._resolve_def(name, loop=loop, cond=cond)
                else:
                    self._taint(
                        f"nested call to `{name}()` (L{call.lineno}) "
                        f"— same-cell defs resolve one level deep "
                        f"only")
                return
            if name in ("exec", "eval"):
                return      # opacity pass owns these
            if name in _DYNAMIC_NS:
                return      # reads are fine; writes flagged already
            if name == "print":
                if loop and any(not isinstance(a, ast.Constant)
                                for a in call.args):
                    self.host_sync = True
                    self.host_sync_in_loop = True
                return
            if name in self._safe_callables:
                return      # from-import of a safe module's attr
            if name in _BUILTIN_NAMES and name not in self.writes \
                    and name not in self._assume_unsafe:
                return      # builtins cannot reach the mesh
            self._taint(f"calls unvetted function `{name}()` "
                        f"(L{call.lineno})")
            return
        if isinstance(fn, ast.Attribute):
            base = _base_name(fn)
            sync = fn.attr in HOST_SYNC_ATTRS
            if sync:
                self.host_sync = True
                if loop:
                    self.host_sync_in_loop = True
            self._expr(fn.value, loop=loop, cond=cond, via=via,
                       depth=depth)
            if fn.attr in _MUTATOR_METHODS:
                # In-place container mutation: a write to the base
                # name's object — and inert for the collective verdict
                # (a custom `.append` that runs a collective is
                # pathological; `history.append(loss)` cells must stay
                # provable).
                if base is not None:
                    self.mutates.add(base)
                    self._read(base)
                return
            if self._inert_chain(fn):
                return      # provably inert module root
            if sync:
                # .item()/.tolist()/.cpu() on a tensor: kept as the
                # JAX package's conservative "may gather" taint.
                self._taint(
                    f"host-sync `.{fn.attr}()` (L{call.lineno}) may "
                    f"gather a cross-host array")
                return
            self._taint(f"calls into `.{fn.attr}()` (L{call.lineno}) "
                        f"— could reach a collective")
            return
        # Dynamic callee: subscripted table, lambda result, call chain.
        self._expr(fn, loop=loop, cond=cond, via=via, depth=depth)
        self._taint(f"dynamic callee at L{call.lineno} — cannot prove "
                    f"it collective-free")

    def _resolve_def(self, name: str, *, loop: int, cond: int) -> None:
        """One level deep through a same-cell def (or lambda-assign):
        its body's calls are classified AT THE CALL SITE's position in
        the top-level order (the collectives it runs happen when it is
        called).  Nested user-function calls inside the body taint
        instead of recursing (``self._depth``), so a recursive def
        terminates with an honest ``unknown``."""
        fndef = self.defs[name]
        saved = self.bound
        self.bound = saved | _param_names(fndef.args)
        self._depth += 1
        saved_scope, self._module_scope = self._module_scope, False
        first_new = len(self.sites)
        try:
            if isinstance(fndef, ast.Lambda):
                self._expr(fndef.body, loop=loop, cond=cond)
            else:
                self._block(fndef.body, loop=loop, cond=cond)
        finally:
            self._depth -= 1
            self._module_scope = saved_scope
            self.bound = saved
        # Tag the sites this resolution added with the via name.
        for site in self.sites[first_new:]:
            if site.via is None:
                site.via = name

    # -- function-object escapes (args, decorators) ---------------------

    def _escape_args(self, call: ast.Call) -> None:
        """Taint any function object escaping through this call's
        arguments unless its body is PROVABLY collective-free — never
        a false 'free' for `list(map(step, data))` or a decorator
        factory's operands."""
        roots = list(call.args) + [kw.value for kw in call.keywords]
        for root in roots:
            for sub in ast.walk(root):
                if isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Load):
                    nm = sub.id
                    if nm in self.defs \
                            and nm not in self._rebound_defs:
                        if not self._fn_free(nm):
                            self._taint(
                                f"same-cell function `{nm}` passed to "
                                f"a call (L{call.lineno}) — its body "
                                f"is not provably collective-free")
                    elif nm in self._def_names:
                        # Conditionally-defined, later-defined, or
                        # rebound function name: the body the callee
                        # would invoke is not resolvable here.
                        self._taint(
                            f"function `{nm}` passed to a call "
                            f"(L{call.lineno}) — its binding is not "
                            f"resolvable at this point")
                elif isinstance(sub, ast.Lambda):
                    if not self._shadow_free(
                            _param_names(sub.args),
                            lambda w, s=sub: w._expr(s.body, loop=0,
                                                     cond=0)):
                        self._taint(
                            f"lambda passed to a call "
                            f"(L{call.lineno}) — not provably "
                            f"collective-free")

    def _fn_free(self, name: str, node: ast.AST | None = None) -> bool:
        """True only when the named same-cell def/lambda's body is
        provably collective-free, so escaping it is harmless no matter
        how often the callee invokes it.  Re-entrant escapes
        (mutually-passing defs) come back False, bounding recursion;
        a name with no resolvable body (and no explicit ``node``) is
        never provably free."""
        if name in self._escape_stack:
            return False
        if node is None:
            node = self.defs.get(name)
        if node is None:
            return False
        self._escape_stack.add(name)
        try:
            if isinstance(node, ast.Lambda):
                return self._shadow_free(
                    _param_names(node.args),
                    lambda w: w._expr(node.body, loop=0, cond=0))
            return self._shadow_free(
                _param_names(node.args),
                lambda w: w._block(node.body, loop=0, cond=0))
        finally:
            self._escape_stack.discard(name)

    def _shadow_free(self, params: set, run) -> bool:
        """Classify a function body in a scratch walker and report
        whether it is provably collective-free (no sites, taints, or
        opacity).  Host-sync flags propagate to the real walker — the
        body runs whenever the callee invokes it; its name footprint
        was already recorded at definition time."""
        sub = _Walker(self._assume_unsafe)
        sub.defs = dict(self.defs)
        sub._def_names = self._def_names
        sub._rebound_defs = set(self._rebound_defs)
        sub._safe_names = set(self._safe_names)
        sub._safe_paths = dict(self._safe_paths)
        sub._safe_callables = set(self._safe_callables)
        sub._escape_stack = self._escape_stack
        # The builtin-inertness check consults writes: a rebound
        # builtin (`float = bad_fn`) must stay rebound inside the
        # shadow body, or the escape check re-proves on a dead
        # assumption.
        sub.writes = set(self.writes)
        sub.bound = set(self.bound) | set(params)
        sub._depth = self._depth + 1
        sub._module_scope = False
        try:
            run(sub)
        except RecursionError:
            return False
        self.host_sync = self.host_sync or sub.host_sync
        self.host_sync_in_loop = (self.host_sync_in_loop
                                  or sub.host_sync_in_loop)
        return not (sub.sites or sub.taints or sub.opaque_reasons)

    def _decorator(self, dec: ast.expr, fndef, *, loop: int,
                   cond: int) -> None:
        """``@dec`` above ``def f`` CALLS ``dec(f)`` when the def
        executes — a call the expression walk alone would miss, which
        is how ``@my_decorator`` escaped classification.  The rules
        mirror :meth:`_call`, with the decorated def as the escaping
        argument."""
        if isinstance(dec, ast.Name):
            self._read(dec.id)
            name = dec.id
            if name in self.defs and name not in self._rebound_defs:
                # Same-cell decorator: its body runs here…
                if self._depth == 0:
                    self._resolve_def(name, loop=loop, cond=cond)
                else:
                    self._taint(
                        f"nested decorator `@{name}` (L{dec.lineno}) "
                        f"— same-cell defs resolve one level deep "
                        f"only")
                # …the decorated def escapes into it, and the name is
                # rebound to whatever the decorator returned.
                if not self._fn_free(fndef.name, fndef):
                    self._taint(
                        f"def `{fndef.name}` passed to decorator "
                        f"`@{name}` (L{dec.lineno}) — its body is not "
                        f"provably collective-free")
                self._rebound_defs.add(fndef.name)
                return
            if name in _NON_INVOKING_DECORATORS \
                    and name not in self.writes \
                    and name not in self._assume_unsafe:
                return   # descriptor wrapper: never calls fndef
            if name in self._safe_callables or (
                    name in _BUILTIN_NAMES
                    and name not in self.writes
                    and name not in self._assume_unsafe):
                # Application itself is inert, but the product may
                # invoke the def — require a provably free body.
                if not self._fn_free(fndef.name, fndef):
                    self._taint(
                        f"def `{fndef.name}` passed to decorator "
                        f"`@{name}` (L{dec.lineno}) — its body is not "
                        f"provably collective-free")
                return
            self._taint(f"decorator `@{name}` (L{dec.lineno}) applies "
                        f"an unvetted function at definition time")
            return
        if isinstance(dec, ast.Attribute):
            base = _base_name(dec)
            self._expr(dec, loop=loop, cond=cond)
            if self._inert_chain(dec):
                # e.g. @functools.cache: the safe-module contract says
                # its product only composes the wrapped body with
                # inert code — so the body itself must be provable.
                if not self._fn_free(fndef.name, fndef):
                    self._taint(
                        f"def `{fndef.name}` passed to decorator "
                        f"`@{base}.{dec.attr}` (L{dec.lineno}) — its "
                        f"body is not provably collective-free")
                return
            self._taint(f"decorator `@….{dec.attr}` (L{dec.lineno}) "
                        f"— could reach a collective at definition "
                        f"time")
            return
        if isinstance(dec, ast.Call):
            # Factory form: the inner call classifies normally (and
            # fndef is not among its args), but the factory's PRODUCT
            # is then invoked with fndef — a dynamic callee.
            self._expr(dec, loop=loop, cond=cond)
            self._taint(f"decorator factory at L{dec.lineno} — cannot "
                        f"prove its product collective-free")
            self._rebound_defs.add(fndef.name)
            return
        self._expr(dec, loop=loop, cond=cond)
        self._taint(f"dynamic decorator at L{dec.lineno} — cannot "
                    f"prove it collective-free")
        self._rebound_defs.add(fndef.name)

    def _safe_callee(self, fn: ast.AST) -> bool:
        """A callee expression that provably cannot reach the mesh on
        its own: a safe from-import / unshadowed builtin Name, or an
        attribute chain rooted in a safe module."""
        if isinstance(fn, ast.Name):
            return fn.id not in self.defs and (
                fn.id in self._safe_callables
                or (fn.id in _BUILTIN_NAMES
                    and fn.id not in self.writes
                    and fn.id not in self._assume_unsafe))
        if isinstance(fn, ast.Attribute):
            return self._inert_chain(fn)
        return False

    def _class_decorator(self, dec: ast.expr, cdef: ast.ClassDef, *,
                         loop: int, cond: int) -> None:
        """``@dec`` above ``class C`` CALLS ``dec(C)`` when the class
        statement executes.  Safe-module decorators (``@dataclass``,
        ``@functools.total_ordering``) introspect the class without
        invoking user code, so they stay provable; anything else could
        instantiate C or call its methods at definition time —
        unprovable, taint."""
        if isinstance(dec, ast.Name):
            self._read(dec.id)
        if self._safe_callee(dec):
            return
        if isinstance(dec, ast.Call):
            # Factory form (`@dataclass(frozen=True)`): the inner call
            # classifies normally; a safe factory's product keeps the
            # introspect-only contract.
            before = len(self.taints)
            safe = self._safe_callee(dec.func)
            self._expr(dec, loop=loop, cond=cond)
            if safe and len(self.taints) == before:
                return
            self._taint(f"class decorator factory at L{dec.lineno} — "
                        f"cannot prove its product collective-free")
            return
        if not isinstance(dec, ast.Name):
            self._expr(dec, loop=loop, cond=cond)
        self._taint(f"class decorator at L{dec.lineno} on "
                    f"`{cdef.name}` — could run the class's code at "
                    f"definition time")

    # -- def name footprint ---------------------------------------------

    def _def_name_footprint(self, fndef) -> None:
        """A def's body runs at call time: free names it loads count
        as reads (conservative), and names it declares ``global`` and
        assigns escape into the module footprint as writes."""
        local: set[str] = set(_param_names(fndef.args))
        glb: set[str] = set()
        for node in ast.walk(fndef):
            if isinstance(node, ast.Global):
                glb.update(node.names)
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)):
                local.add(node.id)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.Lambda)):
                if node is not fndef and getattr(node, "name", None):
                    local.add(node.name)
        for g in glb & local:
            self.writes.add(g)
        local -= glb
        for node in ast.walk(fndef):
            if isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id not in local \
                    and node.id not in self.bound:
                self.reads.add(node.id)


# ----------------------------------------------------------------------


def ambient_poison(report: EffectReport) -> frozenset:
    """The ambient names this cell invalidates for LATER cells in the
    same session: safe roots / builtins it rebinds, mutates, or
    deletes — feed the union of these into the next cell's
    ``assume_unsafe``.  A rebind that re-imports the real module
    (``import numpy as np``) restores the assumption instead of
    breaking it.  An opaque cell could have rebound anything, so it
    poisons every ambient assumption at once."""
    ambient = SAFE_CALL_ROOTS | _BUILTIN_NAMES
    if not report.parsed or report.opaque:
        return frozenset(ambient)
    return frozenset((report.touched & ambient) - report.safe_rearms)


def infer_effects(code: str, *,
                  assume_unsafe: frozenset = frozenset()
                  ) -> EffectReport:
    """Infer one cell's :class:`EffectReport`.  Never raises:
    unreadable source comes back ``parsed=False`` AND ``opaque=True``
    — the conservative verdict that serializes it under effects
    admission and poisons the dependency DAG.

    ``assume_unsafe``: ambient names (safe module roots, builtins) an
    earlier cell in the session rebound — accumulated via
    :func:`ambient_poison` — whose per-cell safety assumption must
    not be trusted here.  A cell can re-arm a root by importing the
    real module itself (``import numpy as np``)."""
    if non_python_cell_magic(code) is not None:
        # %%bash / %%writefile / …: the payload is data for the magic,
        # not Python — no namespace footprint and no mesh collectives,
        # but REAL host side effects (filesystem, subprocesses, pip),
        # so the cell must never read as pure/reorderable.  host_sync
        # is the honest flag: the magic synchronously runs host work.
        return EffectReport(
            parsed=True, opaque=False,
            collective_verdict=VERDICT_NONE,
            host_sync=True)
    try:
        cleaned = strip_ipython(code)
        tree = ast.parse(cleaned)
    except (SyntaxError, ValueError, RecursionError):
        return EffectReport(
            parsed=False, opaque=True,
            opaque_reasons=("unparseable source",),
            collective_verdict=VERDICT_UNKNOWN)
    w = _Walker(assume_unsafe)
    try:
        w.run(tree)
    except RecursionError:
        return EffectReport(
            parsed=False, opaque=True,
            opaque_reasons=("analysis recursion limit",),
            collective_verdict=VERDICT_UNKNOWN)
    opaque = bool(w.opaque_reasons)
    if opaque or w.taints:
        verdict = VERDICT_UNKNOWN
    elif w.sites:
        verdict = VERDICT_EXACT
    else:
        verdict = VERDICT_NONE
    return EffectReport(
        parsed=True,
        opaque=opaque,
        opaque_reasons=tuple(w.opaque_reasons),
        reads=frozenset(w.reads),
        writes=frozenset(w.writes),
        mutates=frozenset(w.mutates),
        deletes=frozenset(w.deletes),
        collectives=tuple(w.sites),
        collective_verdict=verdict,
        taints=tuple(w.taints),
        host_sync=w.host_sync,
        host_sync_in_loop=w.host_sync_in_loop,
        safe_rearms=frozenset(w._rearmed))
