"""Shared finding record for every ``repro_torch.analysis`` pass (port of
``repro.analysis.findings``).

A pass returns ``list[Finding]``; empty means clean. ``rule`` is a stable
id (``REPRO-L003``) documented in the README rule catalog, ``where`` is a
clickable location — ``path/to/file.py:123`` for source passes, a plan
path like ``levels[0].sub.tiles`` for structural passes.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Finding:
    rule: str
    where: str
    message: str

    def to_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:
        return f"{self.rule} {self.where}: {self.message}"


def render(findings: list[Finding]) -> str:
    return "\n".join(str(f) for f in sorted(
        findings, key=lambda f: (f.rule, f.where)))
