"""Finding records, rendering, and the accepted-findings baseline.

The port's own copy of ``repro.analysis.findings`` (the port imports
nothing of the JAX package). A finding prints as ``file:line rule-id
[severity] message``. The baseline maps a finding's stable key,
``file::rule::snippet`` (the stripped source line, so keys survive
unrelated line-number drift), to the number of accepted occurrences.
``new_findings`` returns only the occurrences beyond the accepted
count, which is what the check fails on.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List

SEVERITIES = ("error", "warn", "info")

# Committed at the repo root; python -m repro_torch.analysis loads it
# when present. The port's tree is held clean: it accepts no finding.
DEFAULT_BASELINE = ".repro-torch-lint-baseline.json"

_BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location.

    ``file`` is repo-relative (posix separators); ``snippet`` is the
    stripped source line the finding anchors to, which doubles as the
    stable component of the baseline key.
    """
    file: str
    line: int
    rule: str
    severity: str
    message: str
    snippet: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")

    @property
    def baseline_key(self) -> str:
        return f"{self.file}::{self.rule}::{self.snippet}"

    def render(self) -> str:
        return (f"{self.file}:{self.line} {self.rule} "
                f"[{self.severity}] {self.message}")


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Record every current finding as accepted (atomic rewrite)."""
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.baseline_key] = counts.get(f.baseline_key, 0) + 1
    payload = {"version": _BASELINE_VERSION,
               "findings": dict(sorted(counts.items()))}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def load_baseline(path: str) -> Dict[str, int]:
    """Accepted-occurrence counts by baseline key ({} if no file)."""
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        payload = json.load(fh)
    if payload.get("version") != _BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {payload.get('version')!r}; "
            f"this checker reads version {_BASELINE_VERSION}: "
            "regenerate with --write-baseline")
    counts = payload.get("findings", {})
    if not all(isinstance(v, int) and v > 0 for v in counts.values()):
        raise ValueError(f"baseline {path} is malformed: occurrence "
                         "counts must be positive integers")
    return dict(counts)


def new_findings(findings: Iterable[Finding],
                 baseline: Dict[str, int]) -> List[Finding]:
    """The findings NOT covered by the baseline.

    Each baseline key absorbs up to its accepted count of occurrences
    (identical lines flagged by the same rule in the same file pool
    together); everything beyond that, or under a key the baseline has
    never seen, is new.
    """
    remaining = dict(baseline)
    out = []
    for f in sorted(findings):
        if remaining.get(f.baseline_key, 0) > 0:
            remaining[f.baseline_key] -= 1
        else:
            out.append(f)
    return out
