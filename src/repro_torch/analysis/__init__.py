"""Static analysis for the port (port of ``repro/analysis``).

Three passes, one CLI (``python -m repro_torch.analysis``):

  * ``lint``             — AST rules over ``src/repro_torch`` catching the
                           footguns that carry over to torch: host syncs
                           inside a step function and unregistered dropout
                           policies (analysis/lint.py says which of the
                           reference's JAX rules have no torch meaning).
  * ``contracts``        — run-time checks under a dispatch mode: every
                           workload's train step, model gradients and
                           optimizer update free of float64, the train step,
                           fleet, serving, population and async programs the
                           same op sequence whatever the masks hold (and on
                           the card the same launches, nothing rebuilt), no
                           host sync inside the device programs, and
                           dropped-block dW exactly zero under NaN poison for
                           every FFN width and head count of the zoo, on the
                           CPU's plain versions or the card's kernels.
  * ``kernel_contracts`` — whole-zoo sweep of the kernels' alignment grammar
                           (DESIGN.md §10) through the wrappers on meta
                           tensors, which meet the card's launch checks:
                           tile divisibility, mask shapes, unit-spec tile
                           expansion (including unit-major ``tile < 0``).

Each pass returns plain finding lists so tests can assert on them; the CLI
aggregates exit status. Suppress lint findings with
``# fluidlint: disable=RULE`` (see analysis/lint.py).
"""
from repro_torch.analysis.lint import RULES, Finding, lint_paths, lint_source  # noqa: F401
