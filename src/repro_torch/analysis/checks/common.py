"""Shared finding record + report formatting for the invariant checkers.

Every pass returns a list of :class:`Finding`.  A finding carries an
actionable location (``file:line`` when the pass can resolve one), the
invariant it belongs to, and free-form detail — for the allocator model
checker the detail is the minimal counterexample op trace.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str          # "kernel-aliasing" | "allocator-model" | "mirror-drift"
    invariant: str          # short machine-ish id, e.g. "scatter-scratch-route"
    message: str            # one-line human statement of the violation
    file: Optional[str] = None
    line: Optional[int] = None
    detail: Optional[str] = None   # counterexample trace / extra context

    @property
    def location(self) -> str:
        if self.file is None:
            return "<traced>"
        return f"{self.file}:{self.line}" if self.line else self.file

    def render(self) -> str:
        head = f"[{self.pass_name}] {self.location}: {self.invariant}: {self.message}"
        if self.detail:
            body = "\n".join("    " + ln for ln in self.detail.splitlines())
            return head + "\n" + body
        return head


def render_report(findings: List[Finding]) -> str:
    if not findings:
        return "invariant checks: OK (0 findings)"
    lines = [f.render() for f in findings]
    lines.append(f"invariant checks: {len(findings)} finding(s)")
    return "\n".join(lines)
