"""Health checks of the port's stack (counterpart of
``testground_tpu.healthcheck``): sequential checks with optional fixes
and a report."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

STATUS_OK = "ok"
STATUS_FAILED = "failed"
STATUS_FIXED = "fixed"
STATUS_OMITTED = "omitted; no fix provided"
STATUS_AGGREGATE_FAILED = "failed; fix errored"


@dataclass
class Check:
    name: str
    checker: Callable[[], tuple[bool, str]]  # (ok, message)
    fixer: Optional[Callable[[], str]] = None  # a message; raises on failure


@dataclass
class CheckReport:
    name: str
    status: str
    message: str = ""


@dataclass
class HealthcheckReport:
    checks: list[CheckReport] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.status in (STATUS_OK, STATUS_FIXED) for c in self.checks)

    def render(self) -> str:
        lines = [f"- {c.name}: {c.status}"
                 + (f" ({c.message})" if c.message else "")
                 for c in self.checks]
        lines.append(f"healthcheck: {'OK' if self.ok else 'FAILED'}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "checks": [{"name": c.name, "status": c.status,
                            "message": c.message} for c in self.checks]}

    @classmethod
    def from_dict(cls, d: dict) -> "HealthcheckReport":
        return cls(checks=[CheckReport(c["name"], c["status"],
                                       c.get("message", ""))
                           for c in d.get("checks", [])])


def run_checks(checks: list[Check], fix: bool = False) -> HealthcheckReport:
    """Run each check in order; with ``fix``, a failed check's fixer."""
    report = HealthcheckReport()
    for c in checks:
        try:
            ok, msg = c.checker()
        except Exception as e:  # noqa: BLE001 — a raising check fails
            ok, msg = False, f"checker errored: {e}"
        if ok:
            report.checks.append(CheckReport(c.name, STATUS_OK, msg))
        elif not fix:
            report.checks.append(CheckReport(c.name, STATUS_FAILED, msg))
        elif c.fixer is None:
            report.checks.append(CheckReport(c.name, STATUS_OMITTED, msg))
        else:
            try:
                report.checks.append(
                    CheckReport(c.name, STATUS_FIXED, c.fixer()))
            except Exception as e:  # noqa: BLE001
                report.checks.append(CheckReport(
                    c.name, STATUS_AGGREGATE_FAILED, f"{msg}; fix: {e}"))
    return report
