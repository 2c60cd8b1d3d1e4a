"""``nbd-torch-lint`` — the port's static-analysis CLI (a copy of
``nbdistributed_tpu/analysis/cli.py``; console script and
``tools/nbd_torch_lint.py``).

Modes:

- ``nbd-torch-lint --self [--root ROOT]``: run the ten self-lint
  passes (analysis/selfcheck.py, the analysis/concur.py concurrency
  passes and the analysis/lifecycle.py lifecycle passes) over a
  checkout of the port; nonzero exit on any finding.
- ``nbd-torch-lint FILE [FILE...]`` (or ``-`` for stdin): vet each
  file as a notebook cell with the SPMD analyzer; nonzero exit on
  error-severity findings (``--strict`` also fails on warnings).
  ``--ranks '[0,2]' --world 4`` supplies the dispatch context so the
  subset-collective rule arms.
- ``nbd-torch-lint --lock-graph [--root ROOT]``: emit the port's
  acquires-while-holding lock-order graph as Graphviz dot.
- ``nbd-torch-lint --deps-dot FILE [FILE...]``: treat the files as one
  session's cells in order, infer their effect footprints, and emit
  the cell dependency DAG (RAW/WAR/WAW hazard edges) as dot — the
  ``%dist_lint deps --dot`` analog for scripts.
- ``nbd-torch-lint --knob-table``: print the README "Configuration
  reference" markdown table from the port's knob registry.
- ``nbd-torch-lint --shutdown-ledger [--root ROOT]``: emit the
  lifecycle pass's per-class resource ledger (every resource each
  registered class acquires, and how its shutdown surface releases
  it) as JSON.

``--format json`` switches ``--self`` and file-vetting output to a
single machine-readable JSON document (findings as objects, the exit
code embedded).  ``--format sarif`` emits one SARIF 2.1.0 document
instead (rule ids = self-lint pass names / cell-vetting rule names,
locations = repo-relative file + line); the exit-code contract below
is unchanged in both formats.

Exit codes (pinned by tests/test_torch_lint_cli.py):

- ``0`` — clean: no findings (or none at the failing severity).
- ``1`` — findings: self-lint found violations, or a vetted file has
  error-severity findings (warnings too under ``--strict``).
- ``2`` — usage/environment error: no mode selected, unreadable
  input, or ``--self``/``--lock-graph`` outside a checkout.

When several files produce different codes, the HIGHEST applicable
code wins (an unreadable input exits 2 even if another file also had
findings) — order-independent by contract.

An UNPARSEABLE file (syntax error after IPython stripping) exits 0 by
default — the analyzer's never-block-dispatch contract — but exits 1
under ``--strict``, where the caller asked for hard guarantees and an
uninspectable cell cannot honestly be called clean.  JSON output
carries ``"parsed": false`` either way.
"""

from __future__ import annotations

import argparse
import json as _json
import os
import sys

from .selfcheck import _PKG


def _read_source(path: str) -> tuple[str, str] | None:
    """``(source, label)`` for a file argument (``-`` = stdin), or
    None after printing the OSError — the one read-input helper both
    the vetting and ``--deps-dot`` modes share."""
    if path == "-":
        return sys.stdin.read(), "<stdin>"
    try:
        with open(path, encoding="utf-8") as f:
            return f.read(), path
    except OSError as e:
        print(f"{path}: {e}", file=sys.stderr)
        return None


# One-line rule descriptions for the SARIF rule catalog (self-lint
# pass names; the file mode derives its catalog from the findings).
_SELF_PASS_HELP = {
    "env-knobs": "every NBD_* knob is declared and documented",
    "codec-headers": "wire-extension registry matches the codec",
    "thread-shared-state": "shared mutations hold the owning lock",
    "protocol-coverage": "every sent message type has a handler and "
                         "every handler a sender",
    "lock-order": "the acquires-while-holding graph is acyclic",
    "blocking-under-lock": "no blocking IO while a lock is held",
    "callback-under-lock": "no stored callback invoked under a lock",
    "resource-leak": "acquired resources reach their release on all "
                     "paths including exception edges",
    "bracket-discipline": "paired mutate/unmutate brackets are "
                          "exception-safe",
    "shutdown-completeness": "every class-owned resource is released "
                             "by its shutdown surface",
}


def _sarif_document(results: list[dict]) -> dict:
    """One SARIF 2.1.0 run over ``[{rule, level, message, file,
    line}]`` result dicts.  Rule ids are the self-lint pass names or
    the cell-vetting rule names; locations are repo-relative."""
    seen_rules: dict[str, dict] = {}
    for name, text in _SELF_PASS_HELP.items():
        seen_rules[name] = {"id": name,
                            "shortDescription": {"text": text}}
    out_results = []
    for r in results:
        rid = r["rule"]
        seen_rules.setdefault(rid, {"id": rid, "shortDescription": {
            "text": f"cell-vetting rule {rid}"}})
        out_results.append({
            "ruleId": rid,
            "level": r["level"],
            "message": {"text": r["message"]},
            "locations": [{"physicalLocation": {
                # Repo-relative URI, no uriBaseId: GitHub resolves
                # relative URIs against the checkout root, and a
                # uriBaseId would need an originalUriBaseIds entry to
                # satisfy strict SARIF validators.
                "artifactLocation": {
                    "uri": r["file"].replace(os.sep, "/")},
                "region": {"startLine": max(1, int(r["line"]))},
            }}],
        })
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "nbd-torch-lint",
                "informationUri":
                    "https://github.com/Erland366/nbdistributed",
                "rules": sorted(seen_rules.values(),
                                key=lambda r: r["id"]),
            }},
            "columnKind": "utf16CodeUnits",
            "results": out_results,
        }],
    }


def _repo_root(explicit: str | None) -> str | None:
    if explicit:
        return explicit
    # A checkout holds README.md next to the package dir.  From a
    # non-editable (wheel) install the package's parent is
    # site-packages — no README there, so fall back to the cwd before
    # giving up (running the knob-doc pass against a missing README
    # would flag every declared knob).
    import nbdistributed_tpu_torch
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(nbdistributed_tpu_torch.__file__)))
    for cand in (pkg_parent, os.getcwd()):
        if os.path.isfile(os.path.join(cand, "README.md")) \
                and os.path.isdir(os.path.join(cand, _PKG)):
            return cand
    return None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="nbd-torch-lint",
        description="nbdistributed_tpu_torch static analysis: SPMD "
                    "cell vetting, the port's self-lint (incl. the "
                    "lock-discipline passes), and the graph exports")
    ap.add_argument("files", nargs="*",
                    help="cell/script files to vet ('-' = stdin)")
    ap.add_argument("--self", dest="self_lint", action="store_true",
                    help="run the framework self-lint passes")
    ap.add_argument("--root", default=None,
                    help="repo root for --self/--lock-graph (default: "
                         "the installed package's checkout)")
    ap.add_argument("--ranks", default=None,
                    help="rankspec context for cell vetting, e.g. "
                         "'[0,2]'")
    ap.add_argument("--world", type=int, default=None,
                    help="world size context for cell vetting")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on warning-severity findings")
    ap.add_argument("--format", choices=["text", "json", "sarif"],
                    default="text",
                    help="output format for --self / file vetting "
                         "(json: one document, findings as objects, "
                         "exit code embedded; sarif: one SARIF "
                         "2.1.0 document for GitHub code scanning)")
    ap.add_argument("--shutdown-ledger", action="store_true",
                    help="emit the lifecycle pass's per-class "
                         "resource ledger as JSON")
    ap.add_argument("--lock-graph", action="store_true",
                    help="emit the framework lock-order graph "
                         "(acquires-while-holding) as Graphviz dot")
    ap.add_argument("--deps-dot", action="store_true",
                    help="emit the FILES' cell dependency DAG "
                         "(effect-inferred RAW/WAR/WAW hazards) as "
                         "Graphviz dot")
    ap.add_argument("--knob-table", action="store_true",
                    help="print the configuration-reference markdown "
                         "table from the env-knob registry")
    args = ap.parse_args(argv)

    if args.knob_table:
        from ..utils.knobs import knob_table_markdown
        print(knob_table_markdown())
        return 0

    if args.lock_graph:
        from .concur import lock_graph_dot
        root = _repo_root(args.root)
        if root is None:
            print(f"nbd-torch-lint --lock-graph needs a repo checkout "
                  f"(README.md next to {_PKG}/); run it from one or "
                  f"pass --root", file=sys.stderr)
            return 2
        print(lock_graph_dot(root))
        return 0

    if args.shutdown_ledger:
        from .lifecycle import shutdown_ledger
        root = _repo_root(args.root)
        if root is None:
            print(f"nbd-torch-lint --shutdown-ledger needs a repo "
                  f"checkout (README.md next to {_PKG}/); run it from "
                  f"one or pass --root", file=sys.stderr)
            return 2
        print(_json.dumps(shutdown_ledger(root), indent=1))
        return 0

    if args.deps_dot:
        if not args.files:
            print("nbd-torch-lint --deps-dot needs at least one FILE "
                  "(each file = one session cell, in order)",
                  file=sys.stderr)
            return 2
        from .effects import infer_effects
        from .preflight import dag_from_entries, dag_to_dot
        entries, labels = [], {}
        for seq, path in enumerate(args.files):
            read = _read_source(path)
            if read is None:
                # Unlike vetting (per-file, continues), a DAG with a
                # missing cell is meaningless — abort.
                return 2
            src, label = read
            if label != "<stdin>":
                label = os.path.basename(label)
            entry = {"seq": seq, "sha": label}
            entry.update(infer_effects(src).as_dict())
            entries.append(entry)
            labels[seq] = f"#{seq} {label}"
        print(dag_to_dot(dag_from_entries(entries), labels=labels))
        return 0

    doc: dict = {}
    sarif_rows: list[dict] = []
    rc = 0
    if args.self_lint:
        from .selfcheck import run_self_lint
        root = _repo_root(args.root)
        if root is None:
            print(f"nbd-torch-lint --self needs a repo checkout "
                  f"(README.md next to {_PKG}/); run it from one or "
                  f"pass --root", file=sys.stderr)
            return 2
        results = run_self_lint(root)
        total = sum(len(v) for v in results.values())
        if args.format == "sarif":
            for name, findings in results.items():
                for f in findings:
                    sarif_rows.append({
                        "rule": name, "level": "error",
                        "message": f.message,
                        "file": f.file, "line": f.line})
        elif args.format == "json":
            doc["mode"] = "self"
            doc["root"] = root
            doc["passes"] = {
                name: [{"file": f.file, "line": f.line,
                        "rule": f.rule, "message": f.message}
                       for f in findings]
                for name, findings in results.items()}
            doc["total"] = total
        else:
            for name, findings in results.items():
                status = "clean" if not findings else \
                    f"{len(findings)} finding(s)"
                print(f"[{name}] {status}")
                for f in findings:
                    print(f"  {f.render()}")
            if total:
                print(f"\nnbd-torch-lint --self: {total} finding(s)")
            else:
                print("\nnbd-torch-lint --self: all passes clean")
        if total:
            rc = 1

    if args.files:
        from ..magics import rankspec
        from .cellcheck import vet_cell
        ranks = None
        if args.ranks:
            world = args.world or 0
            if not world:
                print("--ranks needs --world", file=sys.stderr)
                return 2
            ranks = rankspec.parse_ranks(args.ranks, world)
        files_doc: dict = {}
        for path in args.files:
            read = _read_source(path)
            if read is None:
                rc = max(rc, 2)
                continue
            src, label = read
            res = vet_cell(src, ranks=ranks, world=args.world)
            # An unparseable cell never blocks dispatch (rc 0) — but
            # under --strict the caller asked for hard guarantees,
            # and a cell the analyzer could not inspect cannot be
            # called clean.
            bad = ((res.errors or (args.strict and res.warnings))
                   if res.parsed else args.strict)
            if args.format == "sarif":
                if not res.parsed:
                    # The JSON format's "parsed": false, as a result:
                    # an uninspectable cell is at least visible in
                    # code scanning (and a failure under --strict).
                    sarif_rows.append({
                        "rule": "not-analyzable",
                        "level": "warning" if args.strict else "note",
                        "message": "not analyzable (syntax error "
                                   "after IPython stripping) — "
                                   "would dispatch unvetted",
                        "file": label, "line": 1})
                else:
                    for f in res.findings:
                        sarif_rows.append({
                            "rule": f.rule,
                            "level": ("error"
                                      if f.severity == "error"
                                      else "warning"),
                            "message": f.message,
                            "file": label, "line": f.line})
            elif args.format == "json":
                files_doc[label] = {
                    "parsed": res.parsed,
                    "findings": [{"line": f.line,
                                  "severity": f.severity,
                                  "rule": f.rule,
                                  "message": f.message}
                                 for f in res.findings]
                    if res.parsed else []}
            elif not res.parsed:
                print(f"{label}: not analyzable (syntax error after "
                      f"IPython stripping) — "
                      + ("FAILED under --strict" if args.strict
                         else "would dispatch unvetted"))
            else:
                for f in res.findings:
                    print(f"{label}:{f.line}: [{f.severity}] "
                          f"[{f.rule}] {f.message}")
                if not res.findings:
                    print(f"{label}: clean")
            if bad:
                rc = max(rc, 1)
        if args.format == "json":
            doc.setdefault("mode", "files")
            if args.self_lint:
                doc["mode"] = "self+files"
            doc["files"] = files_doc

    if not args.self_lint and not args.files:
        ap.print_help()
        return 2
    if args.format == "sarif":
        print(_json.dumps(_sarif_document(sarif_rows), indent=1))
    elif args.format == "json":
        doc["exit_code"] = rc
        print(_json.dumps(doc, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
