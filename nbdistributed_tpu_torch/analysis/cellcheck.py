"""Pre-dispatch SPMD cell vetting (counterpart of
``nbdistributed_tpu/analysis/cellcheck.py``).

One notebook cell is broadcast SPMD to every rank, so a whole class of
cluster-wrecking bugs is a *textual* property of the cell — detectable
coordinator-side in milliseconds, before dispatch, instead of when the
NCCL group has already deadlocked:

- ``rank-conditional-collective`` (**error**): a world-collective call
  under rank-dependent control flow (``if rank == 0:
  dist.all_reduce(t)``, ``dist.get_rank()`` branches).  Only the
  matching ranks enter the collective; the others never join; the
  process group deadlocks.
- ``subset-collective`` (**error**): the cell's ``%%rank`` spec
  targets a strict subset of the world, yet the cell calls world-size
  collectives — the textual twin of the runtime guard's
  ``CollectiveHazardError`` (runtime/collective_guard.py), raised
  before a single byte ships.
- ``rank-conditional-exit`` (**error**): a ``return``/``break``/
  ``continue``/``raise`` on a rank-dependent path with collectives
  still ahead — the exiting rank desyncs the collective sequence and
  every later collective pairs wrong ranks.
- ``host-sync-in-loop`` (**warning**): blocking host transfers inside
  a loop — ``.item()``/``.tolist()``/``.cpu()``,
  ``torch.cuda.synchronize()``, printing device values — the
  submission/completion coupling that starves the GPU's queue and
  blocks the async window.
- ``namespace-shadow`` (**warning**): assigning or ``del``-ing a
  seeded framework name (``rank``, ``dist``, ``device``,
  ``all_reduce``, …) — every later cell in the session inherits the
  breakage.

Each finding's text is the JAX package's, word for word, so a
transcript of findings prints the same in both packages.

Severity contract: **error** findings are reserved for shapes that
deadlock or diverge the group; perf/hygiene lints stay warnings.  The
magic layer annotates by default and blocks only under
``%%distributed --strict`` / ``%dist_lint strict`` — and NEVER blocks
on unparseable source (``VetResult.parsed`` is False and the findings
list empty).

**The torch vocabulary.**  The rules are the JAX package's; the name
tables follow the port worker's seeded namespace
(``runtime/worker.py``: ``torch``, ``np``, ``dist``, ``device``,
``gpu_id`` and the functional collectives), so a cell written in the
vocabulary both packages share (the bare functional collectives,
``dist.all_reduce``/``broadcast``/``barrier``, ``rank``, ``np``,
``.item()``/``.tolist()``) gets the same findings from both.  Where
they differ, the framework differs:

- torch's own collective spellings count (``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_to_all_single``, the ``*_object``
  collectives, ``batch_isend_irecv``, ``monitored_barrier``; the
  point-to-point ``send``/``recv``/``isend``/``irecv`` only through a
  ``dist``/``torch.distributed`` root, since a socket has ``.send``
  too);
- ``gather``/``scatter``/``reduce`` are collectives as bare seeded
  names and through a ``dist``/``torch.distributed`` root only:
  ``logits.gather(-1, labels)`` and ``torch.gather(...)`` are a loss
  cell's ordinary compute, and no ``torch.``-rooted call outside
  ``torch.distributed`` is a collective;
- ``gpu_id`` and ``dist.get_rank()`` are rank-dependent;
- ``.cpu()`` and ``torch.cuda.synchronize()`` are host syncs (torch
  has no ``block_until_ready``/``device_get``);
- ``FRAMEWORK_NAMES`` is the load-bearing subset of the port worker's
  seeded names (no ``jax``/``jnp``/``NamedSharding``).

Stdlib-only (ast).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .ipycompat import strip_ipython

# The seeded functional collectives (parallel/collectives.py), their
# ``dist.*`` spellings, the mesh's collectives (``Mesh.psum``,
# ``ppermute``, ``all_to_all``) and the JAX package's names, plus
# torch.distributed's own spellings.
COLLECTIVE_NAMES = frozenset({
    "all_reduce", "all_reduce_quantized", "all_gather", "broadcast",
    "reduce_scatter", "barrier", "scatter", "gather", "reduce",
    "psum", "pmean", "pmax", "pmin", "ppermute", "all_to_all",
    "sync_global_devices",
    # torch.distributed
    "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "all_gather_object", "broadcast_object_list",
    "gather_object", "scatter_object_list", "send", "recv", "isend",
    "irecv", "batch_isend_irecv", "monitored_barrier",
})

# Names that are also ordinary compute (``logits.gather``,
# ``torch.scatter``, ``functools.reduce``): a collective only as a
# bare seeded name or through a ``dist``/``torch.distributed`` root.
AMBIGUOUS_NAMES = frozenset({"gather", "scatter", "reduce"})

# Point-to-point ops: a socket or a queue has ``.send`` too, and none
# is seeded bare — a collective only through a ``dist`` root.
P2P_NAMES = frozenset({"send", "recv", "isend", "irecv"})

# Expression atoms that make a condition rank-dependent: different
# ranks see different values, so a branch on them diverges SPMD flow.
RANK_ATOMS = frozenset({"rank", "__rank__", "process_index",
                        "process_id", "gpu_id", "get_rank"})

# Host-blocking attribute calls: each forces a device→host transfer
# (or a full device sync) at call time.
HOST_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "synchronize"})

# Seeded framework names whose shadowing/deletion breaks every later
# cell (runtime/worker.py's seeded namespace; the load-bearing subset).
FRAMEWORK_NAMES = frozenset({
    "rank", "world_size", "torch", "np", "dist", "device", "gpu_id",
    "Mesh", "P", "PartitionSpec", "shard_map", "all_reduce",
    "all_gather", "broadcast", "barrier", "reduce_scatter",
    "all_reduce_quantized", "make_mesh", "shard_batch",
})

# ``import <module> as <name>`` forms that rebind a framework name to
# the very module the worker seeded under it: the idiomatic no-op.
_SAME_MODULE_IMPORTS = {"torch": "torch", "np": "numpy",
                        "dist": "torch.distributed"}


def _attr_path(node: ast.AST) -> list[str] | None:
    """The dotted name of a plain attribute chain, root first
    (``torch.distributed.all_reduce`` → ``["torch", "distributed",
    "all_reduce"]``); None when the chain passes through a call or a
    subscript."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return parts[::-1]


def _dist_rooted(path: list[str] | None) -> bool:
    return bool(path) and (path[0] == "dist" or path[:2] == ["torch",
                                                             "distributed"])


def collective_op(fn: ast.AST) -> str | None:
    """The collective a call's callee invokes, or None (the port's
    rule; the JAX package counts any name in its table on any root)."""
    if isinstance(fn, ast.Name):
        return (fn.id if fn.id in COLLECTIVE_NAMES
                and fn.id not in P2P_NAMES else None)
    if not isinstance(fn, ast.Attribute) \
            or fn.attr not in COLLECTIVE_NAMES:
        return None
    path = _attr_path(fn)
    if _dist_rooted(path):
        return fn.attr
    if path is not None and path[0] == "torch":
        return None          # torch.gather, torch.cuda.comm.broadcast
    if fn.attr in AMBIGUOUS_NAMES or fn.attr in P2P_NAMES:
        return None          # a tensor's .gather, a socket's .send
    return fn.attr           # mesh.psum(...), collectives.all_reduce(...)


_SEVERITY_ORDER = {"error": 0, "warning": 1, "info": 2}


@dataclass
class Finding:
    rule: str
    severity: str          # "error" | "warning" | "info"
    line: int
    col: int
    message: str
    snippet: str = ""

    def render(self) -> str:
        mark = "⛔" if self.severity == "error" else "⚠️"
        loc = f"L{self.line}"
        out = f"{mark} {loc} [{self.rule}] {self.message}"
        if self.snippet:
            out += f"\n      {loc}: {self.snippet.strip()}"
        return out


@dataclass
class VetResult:
    findings: list[Finding] = field(default_factory=list)
    parsed: bool = True

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]


def _is_rank_dependent(node: ast.AST) -> bool:
    """Does this expression read a per-rank value?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in RANK_ATOMS:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in RANK_ATOMS:
            return True
    return False


def _collective_called(node: ast.Call) -> str | None:
    """The collective name this call invokes, or None."""
    return collective_op(node.func)


def _bound_names(target: ast.AST) -> list[ast.AST]:
    """Name-binding nodes inside an assignment/for/with target
    (attributes and subscripts mutate objects, not the namespace: the
    JAX package walks every Name of the target, so its
    ``jax.config.x = 1`` or ``state[rank] = 1`` warns that ``jax`` or
    ``rank`` is shadowed; the port's ``torch.backends.cudnn.benchmark =
    True`` does not)."""
    if isinstance(target, ast.Name):
        return [target]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for el in target.elts for n in _bound_names(el)]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return []


class _Analyzer:
    def __init__(self, source: str, *, subset: bool):
        self.lines = source.splitlines()
        self.subset = subset
        self.findings: list[Finding] = []
        # Statements remaining after each node within the enclosing
        # scope — filled during the walk for the desync-exit rule.
        self._collective_mentions = 0

    # ------------------------------------------------------------------

    def _snippet(self, node: ast.AST) -> str:
        ln = getattr(node, "lineno", 0)
        if 1 <= ln <= len(self.lines):
            return self.lines[ln - 1]
        return ""

    def _add(self, rule: str, severity: str, node: ast.AST,
             message: str) -> None:
        self.findings.append(Finding(
            rule=rule, severity=severity,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message, snippet=self._snippet(node)))

    # ------------------------------------------------------------------

    def run(self, tree: ast.Module) -> list[Finding]:
        self._walk(list(tree.body), rank_cond=None, loop=False,
                   in_def=False, collectives_after=None)
        self._scan_subset(tree)
        self._scan_namespace(tree)
        # A node can be reached through more than one context path
        # (e.g. a collective inside a rank-dependent IfExp that also
        # sits under a rank-dependent `if`): one finding per site.
        seen: set = set()
        unique: list[Finding] = []
        for f in self.findings:
            key = (f.rule, f.severity, f.line, f.col)
            if key in seen:
                continue
            seen.add(key)
            unique.append(f)
        unique.sort(key=lambda f: (_SEVERITY_ORDER.get(
            f.severity, 9), f.line, f.col))
        self.findings = unique
        return self.findings

    # ------------------------------------------------------------------
    # core walk: rank-conditional collectives, desync exits, host syncs

    def _stmts_have_collective(self, stmts: list[ast.stmt]) -> bool:
        for s in stmts:
            for sub in ast.walk(s):
                if isinstance(sub, ast.Call) and _collective_called(sub):
                    return True
        return False

    def _walk(self, body: list[ast.stmt], *, rank_cond, loop: bool,
              in_def: bool, collectives_after) -> None:
        """Visit a statement list.  ``rank_cond`` is the innermost
        rank-dependent branch node (or None); ``collectives_after``
        is a callable () -> bool answering "do collectives still lie
        ahead of the current statement in this scope or an enclosing
        loop body" — the desync-exit evidence."""
        for i, stmt in enumerate(body):
            rest = body[i + 1:]

            def later(rest=rest, outer=collectives_after):
                if self._stmts_have_collective(rest):
                    return True
                return outer() if outer is not None else False

            self._visit_stmt(stmt, rank_cond=rank_cond, loop=loop,
                             in_def=in_def, collectives_after=later)

    def _visit_stmt(self, stmt: ast.stmt, *, rank_cond, loop: bool,
                    in_def: bool, collectives_after) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A def body runs when CALLED, not here: analyze it as its
            # own scope.  A rank-conditional around the *definition*
            # does not execute collectives, so the context resets —
            # but a rank-conditional inside the body still counts when
            # every rank later calls the function.
            self._walk(list(stmt.body), rank_cond=None, loop=False,
                       in_def=True, collectives_after=None)
            return
        if isinstance(stmt, ast.ClassDef):
            self._walk(list(stmt.body), rank_cond=None, loop=False,
                       in_def=True, collectives_after=None)
            return

        if isinstance(stmt, (ast.If, ast.While)):
            cond_rank = _is_rank_dependent(stmt.test)
            branch_cond = stmt if cond_rank else rank_cond
            self._scan_expr(stmt.test, rank_cond=rank_cond, loop=loop)
            body = list(stmt.body)
            after = collectives_after
            if isinstance(stmt, ast.While):
                # Like For: a break/continue skips this loop body's
                # remaining ITERATIONS, so collectives anywhere in the
                # body still count as "ahead".
                def after(body=body, outer=collectives_after):
                    if self._stmts_have_collective(body):
                        return True
                    return outer() if outer is not None else False

            self._walk(body, rank_cond=branch_cond,
                       loop=loop or isinstance(stmt, ast.While),
                       in_def=in_def, collectives_after=after)
            self._walk(list(stmt.orelse), rank_cond=branch_cond,
                       loop=loop, in_def=in_def,
                       collectives_after=collectives_after)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            body = list(stmt.body)

            def in_loop(body=body, outer=collectives_after):
                # break/continue desync evidence: collectives anywhere
                # in this loop's body (the skipped iterations), or
                # later in the enclosing scope.
                if self._stmts_have_collective(body):
                    return True
                return outer() if outer is not None else False

            self._scan_expr(stmt.iter, rank_cond=rank_cond, loop=loop)
            self._walk(body, rank_cond=rank_cond, loop=True,
                       in_def=in_def, collectives_after=in_loop)
            self._walk(list(stmt.orelse), rank_cond=rank_cond,
                       loop=loop, in_def=in_def,
                       collectives_after=collectives_after)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr, rank_cond=rank_cond,
                                loop=loop)
            self._walk(list(stmt.body), rank_cond=rank_cond, loop=loop,
                       in_def=in_def,
                       collectives_after=collectives_after)
            return
        if isinstance(stmt, ast.Try):
            for part in (stmt.body, stmt.orelse, stmt.finalbody,
                         *[h.body for h in stmt.handlers]):
                self._walk(list(part), rank_cond=rank_cond, loop=loop,
                           in_def=in_def,
                           collectives_after=collectives_after)
            return
        if isinstance(stmt, ast.Match):
            # ``match rank: case 0: all_reduce(x)`` — a rank-dependent
            # subject (or case guard) routes different ranks into
            # different arms, same divergence as a rank `if`.
            subj_rank = _is_rank_dependent(stmt.subject)
            self._scan_expr(stmt.subject, rank_cond=rank_cond,
                            loop=loop)
            for case in stmt.cases:
                case_rank = subj_rank or (
                    case.guard is not None
                    and _is_rank_dependent(case.guard))
                if case.guard is not None:
                    self._scan_expr(case.guard, rank_cond=rank_cond,
                                    loop=loop)
                self._walk(list(case.body),
                           rank_cond=stmt if case_rank else rank_cond,
                           loop=loop, in_def=in_def,
                           collectives_after=collectives_after)
            return

        # --- leaf statements ------------------------------------------
        if isinstance(stmt, (ast.Return, ast.Break, ast.Continue,
                             ast.Raise)):
            # ``return all_reduce(x)`` under a rank branch: the value
            # expression is itself a rank-conditional collective.
            for sub_expr in ast.iter_child_nodes(stmt):
                if isinstance(sub_expr, ast.expr):
                    self._scan_expr(sub_expr, rank_cond=rank_cond,
                                    loop=loop)
            if rank_cond is not None and collectives_after is not None \
                    and collectives_after():
                kind = type(stmt).__name__.lower()
                self._add(
                    "rank-conditional-exit", "error", stmt,
                    f"`{kind}` on a rank-dependent path (the `if` at "
                    f"L{rank_cond.lineno}) with collectives still "
                    f"ahead — the exiting rank(s) desync the "
                    f"collective sequence and every later collective "
                    f"pairs wrong ranks (the guard tracks this "
                    f"sequence; see runtime/collective_guard.py)")
            return
        # Generic expression scan for everything else.
        for sub_expr in ast.iter_child_nodes(stmt):
            if isinstance(sub_expr, ast.expr):
                self._scan_expr(sub_expr, rank_cond=rank_cond,
                                loop=loop)

    def _scan_expr(self, expr: ast.expr, *, rank_cond, loop: bool
                   ) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.IfExp) and \
                    _is_rank_dependent(node.test):
                for side in (node.body, node.orelse):
                    for sub in ast.walk(side):
                        if isinstance(sub, ast.Call):
                            op = _collective_called(sub)
                            if op:
                                self._flag_rank_conditional(sub, op,
                                                            node)
                continue
            if not isinstance(node, ast.Call):
                continue
            op = _collective_called(node)
            if op and rank_cond is not None:
                self._flag_rank_conditional(node, op, rank_cond)
            if loop:
                self._scan_host_sync(node)

    def _flag_rank_conditional(self, call: ast.Call, op: str,
                               cond: ast.AST) -> None:
        self._add(
            "rank-conditional-collective", "error", call,
            f"`{op}(...)` runs under rank-dependent control flow "
            f"(the branch at L{getattr(cond, 'lineno', '?')}): only "
            f"the matching rank(s) enter the collective, the rest "
            f"never join, and the mesh deadlocks until the hang "
            f"watchdog breaks it — hoist the collective out of the "
            f"branch or make the condition uniform across ranks")

    def _scan_host_sync(self, call: ast.Call) -> None:
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in HOST_SYNC_ATTRS:
            self._add(
                "host-sync-in-loop", "warning", call,
                f"`.{fn.attr}()` inside a loop forces a blocking "
                f"device→host sync every iteration — hoist it out of "
                f"the loop (or log every N steps) to keep the "
                f"accelerator queue full")
            return
        name = (fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute) else None)
        if name == "print" and any(
                not isinstance(a, ast.Constant) for a in call.args):
            self._add(
                "host-sync-in-loop", "warning", call,
                "printing computed values inside a loop blocks on "
                "device results every iteration — print every N "
                "steps, or collect and print after the loop")

    # ------------------------------------------------------------------
    # subset-rankspec vs collectives

    def _scan_subset(self, tree: ast.Module) -> None:
        if not self.subset:
            return
        referenced: list[tuple[ast.AST, str]] = []
        called: list[tuple[ast.Call, str, bool]] = []
        # Track which call nodes live inside a def: defining a helper
        # on a subset is fine until it is called — warning, not error.
        def_spans: list[tuple[int, int]] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                end = getattr(node, "end_lineno", node.lineno)
                def_spans.append((node.lineno, end))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                op = _collective_called(node)
                if op:
                    ln = node.lineno
                    in_def = any(lo <= ln <= hi for lo, hi in def_spans)
                    called.append((node, op, in_def))
            elif isinstance(node, ast.Name) \
                    and node.id in COLLECTIVE_NAMES \
                    and node.id not in P2P_NAMES \
                    and not isinstance(node.ctx, ast.Store):
                referenced.append((node, node.id))
        called_lines = {c.lineno for c, _, _ in called}
        for call, op, in_def in called:
            sev = "warning" if in_def else "error"
            where = (" (inside a function definition — hazardous the "
                     "moment it is called)" if in_def else "")
            self._add(
                "subset-collective", sev, call,
                f"`{op}(...)` in a cell targeted at a strict subset "
                f"of the mesh{where}: a world-collective entered by a "
                f"subset never completes (the absent ranks never "
                f"join) and would deadlock the cluster — run the "
                f"cell on all ranks, or keep subset cells to "
                f"rank-local work")
        for node, name in referenced:
            if node.lineno in called_lines:
                continue
            self._add(
                "subset-collective-ref", "warning", node,
                f"cell names the collective `{name}` but targets a "
                f"subset of the mesh — calling it from these ranks "
                f"would deadlock the cluster")

    # ------------------------------------------------------------------
    # namespace hazards

    def _scan_namespace(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            targets: list[ast.AST] = []
            verb = "assignment shadows"
            if isinstance(node, ast.Assign):
                targets = [t for tgt in node.targets
                           for t in _bound_names(tgt)]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = _bound_names(node.target)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                targets = _bound_names(node.target)
                verb = "loop target shadows"
            elif isinstance(node, ast.Delete):
                targets = [t for tgt in node.targets
                           for t in _bound_names(tgt)]
                verb = "`del` removes"
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.ClassDef)):
                if node.name in FRAMEWORK_NAMES:
                    self._add("namespace-shadow", "warning", node,
                              f"definition shadows the seeded "
                              f"framework name `{node.name}` — every "
                              f"later cell in this session sees the "
                              f"shadow, not the framework object")
                continue
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    # ``import torch`` / ``import numpy as np`` /
                    # ``import torch.distributed as dist`` rebind a
                    # framework name to the module seeded under it —
                    # the idiomatic no-op, never a hazard.
                    module = (f"{node.module}.{alias.name}"
                              if isinstance(node, ast.ImportFrom)
                              and node.module else alias.name)
                    if bound in ("torch", "np") or \
                            _SAME_MODULE_IMPORTS.get(bound) == module:
                        continue
                    if bound in FRAMEWORK_NAMES:
                        self._add(
                            "namespace-shadow", "warning", node,
                            f"import binds `{bound}` over the seeded "
                            f"framework name — later cells lose the "
                            f"framework object")
                continue
            else:
                continue
            for t in targets:
                name = getattr(t, "id", None)
                if name in FRAMEWORK_NAMES:
                    self._add(
                        "namespace-shadow", "warning", t,
                        f"{verb} the seeded framework name `{name}` "
                        f"— every later cell in this session sees "
                        f"the shadow; pick another name (the rank-"
                        f"dependence and collective checks also key "
                        f"on it)")


def vet_cell(code: str, *, ranks=None, world: int | None = None
             ) -> VetResult:
    """Statically vet one cell before dispatch.

    ``ranks``/``world`` give the dispatch context: when ``ranks`` is a
    strict subset of ``world`` the subset-collective rule arms.
    Never raises; unparseable source (after IPython stripping) comes
    back as ``VetResult(parsed=False)`` with no findings — vetting
    must never block dispatch on source it cannot read.
    """
    subset = bool(ranks is not None and world
                  and len(set(ranks)) < int(world))
    try:
        cleaned = strip_ipython(code)
        tree = ast.parse(cleaned)
    except (SyntaxError, ValueError, RecursionError):
        return VetResult(findings=[], parsed=False)
    try:
        findings = _Analyzer(cleaned, subset=subset).run(tree)
    except RecursionError:
        return VetResult(findings=[], parsed=False)
    return VetResult(findings=findings, parsed=True)
