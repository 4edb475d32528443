"""repro-lint for the port: static and dispatch-level contract checks.

The port's twin of ``repro.analysis``. Its contracts are those of the
JAX package's engine, carried into torch:

* **AST tier** (``repro_torch.analysis.ast_rules``), pure stdlib over
  ``src/repro_torch/``: every kernel wrapper that reaches
  ``build.load_library`` has a plain version with its signature in
  ``kernels/ref.py``; quantized receives that can see the folded sign
  wire restore the zero tail; round bodies make no draw; and module
  import hygiene. The rules read source and run none of it.
* **dispatch tier** (``repro_torch.analysis.dispatch_checks``), the
  twin of the JAX package's jaxpr tier: one resident round of a tiny
  cell on the CPU under a ``TorchDispatchMode`` dispatches no random
  op on any wire, narrows no f32 tensor on the all-f32 wire, and its
  draws providers give the fields the round reads.

Run ``python -m repro_torch.analysis`` (add ``--dispatch`` for the
second tier). The committed baseline
(``.repro-torch-lint-baseline.json``) accepts no finding: the port's
tree is held clean, and a by-design exception is waived in place with
a trailing ``# repro-lint: allow[<rule-id>]`` comment and its reason
(``lazy-import`` is the waiver for a deliberate function-local import).
"""

from repro_torch.analysis.ast_rules import (AST_RULES, analyze_paths,
                                            analyze_repo, analyze_sources)
from repro_torch.analysis.findings import (DEFAULT_BASELINE, Finding,
                                           load_baseline, new_findings,
                                           write_baseline)

__all__ = [
    "AST_RULES", "DEFAULT_BASELINE", "Finding", "analyze_paths",
    "analyze_repo", "analyze_sources", "load_baseline", "new_findings",
    "write_baseline",
]
