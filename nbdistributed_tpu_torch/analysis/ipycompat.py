"""IPython-syntax-aware source cleaning for AST consumers (a copy of
``nbdistributed_tpu/analysis/ipycompat.py``, stdlib only).

Notebook cells are not quite Python: line magics (``%time f()``),
shell escapes (``!pip list``, ``files = !ls``), help syntax
(``obj?``/``?obj``) and a leading cell magic (``%%time``) all fail
``ast.parse``.  :func:`strip_ipython` rewrites exactly those lines to
``pass`` **without changing the line count or indentation**, so every
finding an AST pass reports still points at the user's real line —
the one shared helper for the cell analyzer and any future AST
consumer.

Two guards keep string literals intact: source that already parses is
returned verbatim (a ``!cmd`` line inside a triple-quoted template is
DATA, not IPython syntax), and the rewrite pass tracks triple-quote
state so a string's interior lines are never replaced even in cells
that genuinely mix multi-line strings with magic lines.

Cell magics: a leading ``%%name`` line governs
the WHOLE cell in IPython, and which rewrite is right depends on the
magic.  Python-body cell magics (``%%time``, ``%%capture``,
``%%prun``, …) execute the remainder as Python — the magic line
becomes ``pass`` and the rest is vetted normally, so a nested
``%%time`` first line no longer costs the cell its vetting.
Non-Python cell magics (``%%bash``, ``%%writefile``, ``%%html``, …)
treat the remainder as DATA — every line is masked to ``pass`` so the
cell parses cleanly (and correctly yields zero findings) instead of
coming back unparseable/unvetted.
"""

from __future__ import annotations

import ast
import re

# ``x = !cmd`` / ``x = %magic`` assignment capture: IPython grammar
# allows a simple target list before the escape.
_ASSIGN_ESCAPE = re.compile(
    r"^\s*[\w.]+(\s*,\s*[\w.]+)*\s*=\s*[!%]")
_HELP_SUFFIX = re.compile(r"^[^#'\"]*\?{1,2}\s*$")
# ``%magic`` lines need a word character right after the percent: a
# bare ``% b`` could be a wrapped modulo continuation line, which must
# survive untouched.  ``%%``-leading lines are ALWAYS IPython syntax —
# no Python statement or continuation can start with ``%%`` (``%`` is
# a binary operator; two in a row never parse), so even a bare or
# symbol-led ``%%…`` line is safe to rewrite.
_MAGIC_PREFIX = re.compile(r"%{1,2}\w")

# Cell magics whose body is NOT Python: the remainder is data for the
# magic, so the right vetting answer is "parses, nothing to report" —
# not "unparseable, unvetted".  (Python-body magics — %%time,
# %%timeit, %%capture, %%prun, %%px, %%distributed, %%rank, and
# unknown ones by default — keep the remainder and vet it.)
NON_PYTHON_CELL_MAGICS = frozenset({
    "bash", "sh", "script", "system", "cmd", "powershell", "perl",
    "ruby", "js", "javascript", "html", "latex", "svg", "markdown",
    "writefile", "file", "sql", "pypy", "python2",
})

_CELL_MAGIC_NAME = re.compile(r"^%%([\w.]+)")


def non_python_cell_magic(source: str) -> str | None:
    """The leading non-Python cell magic's name (``"bash"`` for a
    ``%%bash`` cell), or None when the cell is (possibly magic-headed)
    Python.  The sentinel effect consumers need: a masked non-Python
    cell parses as all-``pass`` but still has REAL host side effects
    (filesystem writes, subprocesses), so it must never be reported
    pure/reorderable."""
    lines = source.splitlines()
    first = lines[0].strip() if lines else ""
    m = _CELL_MAGIC_NAME.match(first)
    if m and m.group(1).split(".")[0] in NON_PYTHON_CELL_MAGICS:
        return m.group(1).split(".")[0]
    return None


def _is_ipython_line(stripped: str) -> bool:
    if not stripped:
        return False
    if stripped.startswith(("!", "?")):
        return True
    if stripped.startswith("%%"):
        return True
    if stripped.startswith("%") and _MAGIC_PREFIX.match(stripped):
        return True
    if _ASSIGN_ESCAPE.match(stripped):
        return True
    # Trailing ``?``/``??`` help (``obj.method?``) — but not inside a
    # comment or string, which the cheap regex above excludes.
    if _HELP_SUFFIX.match(stripped):
        return True
    return False


_TRIPLE = re.compile(r"'''|\"\"\"")


def _track_triple(line: str, in_string: str | None) -> str | None:
    """Advance the open-triple-quote state across one line.  Inline
    comments are honored only outside a string; escaped quotes and
    single-quoted strings containing triple-quote text are rare enough
    in notebook cells that the parse-first shortcut above handles
    them."""
    pos = 0
    while True:
        if in_string is None:
            hash_at = line.find("#", pos)
            m = _TRIPLE.search(line, pos)
            if not m or (hash_at != -1 and hash_at < m.start()):
                return None
            in_string = m.group(0)
            pos = m.end()
        else:
            close = line.find(in_string, pos)
            if close == -1:
                return in_string
            in_string = None
            pos = close + 3


def strip_ipython(source: str) -> str:
    """Replace IPython-only lines with ``pass`` (indentation kept) so
    the result parses with ``ast.parse`` while every surviving node
    keeps its original line number.  Sources that already parse —
    pure Python, including multi-line strings whose content LOOKS
    like shell/magic syntax — come back unchanged."""
    try:
        ast.parse(source)
        return source
    except (SyntaxError, ValueError):
        pass
    if non_python_cell_magic(source) is not None:
        # The whole cell is the magic's (non-Python) payload: mask
        # every line so the result parses and reports nothing, instead
        # of the remainder failing ast.parse and blinding the vetting.
        indent_pass = "\n".join(
            "pass" for _ in source.splitlines()) or "pass"
        if source.endswith("\n"):
            indent_pass += "\n"
        return indent_pass
    out: list[str] = []
    changed = False
    in_string: str | None = None
    for line in source.splitlines():
        stripped = line.strip()
        if in_string is None and _is_ipython_line(stripped):
            indent = line[:len(line) - len(line.lstrip())]
            out.append(indent + "pass")
            changed = True
        else:
            in_string = _track_triple(line, in_string)
            out.append(line)
    if not changed:
        return source
    cleaned = "\n".join(out)
    if source.endswith("\n"):
        cleaned += "\n"
    return cleaned
