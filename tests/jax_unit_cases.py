"""The JAX package's unit-test files as namespaces for the port's tests.

``load(name, pkg)`` compiles ``tests/unit/<name>``, with its
``nbdistributed_tpu.`` imports pointed at ``nbdistributed_tpu_torch.``
when ``pkg`` is ``"torch"`` (``"jax"`` leaves them as they are), and
returns the module's namespace: its fakes and helpers, and its
``test_*`` cases, which then hold the port to exactly what they hold the
JAX package to.  ``cases`` picks those test functions out.
"""

import functools
import os
import re

UNIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unit")


@functools.cache
def load(name: str, pkg: str) -> dict:
    path = os.path.join(UNIT, name)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    if pkg == "torch":
        src = re.sub(r"\bnbdistributed_tpu\.", "nbdistributed_tpu_torch.",
                     src)
    ns = {"__name__": f"{name[:-3]}_cases_{pkg}"}
    exec(compile(src, f"{path}[{pkg}]", "exec"), ns)
    return ns


def cases(ns: dict, names=None, suffix: str = "") -> dict:
    """The namespace's ``test_*`` functions (those of ``names`` when
    given), each under its name plus ``suffix``."""
    names = names or [n for n in ns if n.startswith("test_")
                      and callable(ns[n])]
    return {n + suffix: ns[n] for n in names}
