"""Static analysis of notebook cells (counterpart of
``nbdistributed_tpu/analysis``): the pre-dispatch vetting the
``%%distributed``/``%%rank`` magics run coordinator-side BEFORE
``send_to_ranks``.

- **Cell vetting** (:mod:`cellcheck`): an IPython-syntax-aware AST
  analyzer — rank-conditional collectives, subset-rankspec
  collectives, rank-conditional early exits, blocking host syncs in
  loops, namespace shadowing.  Findings annotate by default,
  hard-block under ``--strict``/``%dist_lint strict``, are
  flight-recorded and counted (``nbd_lint_findings_total{rule}``).

- **Effect inference** (:mod:`effects`): per-cell
  :class:`~.effects.EffectReport` — name footprint (reads / writes /
  mutations / deletes, with an ``opaque`` verdict for dynamic
  escapes), the *ordered* collective footprint (none / exact /
  unknown), and host-sync/purity flags.  :mod:`preflight` keeps each
  dispatched cell's footprint and draws the session's cell dependency
  DAG (``%dist_lint deps``), which gates the async in-flight window
  (``messaging/pipeline.py``).

- **Self-lint** (:mod:`selfcheck`, :mod:`concur`, :mod:`lifecycle`,
  :mod:`cli`): the ten passes over the port's own tree — the env-knob,
  codec and protocol registries, thread-shared state, lock order,
  blocking calls and callbacks under a lock, resource leaks, bracket
  discipline and shutdown completeness — run by
  ``tools/nbd_torch_lint.py --self`` (``nbd-torch-lint``) and
  ``%dist_lint self``.

Everything here is stdlib-only (ast + re) and safe to import from
any layer.
"""

from .cellcheck import (COLLECTIVE_NAMES, FRAMEWORK_NAMES, Finding,
                        VetResult, vet_cell)
from .effects import (CollectiveSite, EffectReport, collective_class,
                      infer_effects)
from .ipycompat import strip_ipython

__all__ = ["vet_cell", "VetResult", "Finding", "strip_ipython",
           "COLLECTIVE_NAMES", "FRAMEWORK_NAMES", "EffectReport",
           "CollectiveSite", "infer_effects", "collective_class"]
