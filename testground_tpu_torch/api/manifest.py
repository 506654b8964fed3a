"""The test plan manifest (``manifest.toml``), a copy of
``testground_tpu/api/manifest.py``: a plan's name, the builders and
runners it supports (with their config maps), and its test cases with
instance bounds and typed parameters."""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class InstanceConstraints:
    minimum: int = 1
    maximum: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "InstanceConstraints":
        return cls(minimum=int(d.get("min", 1)), maximum=int(d.get("max", 1)))


@dataclass
class Parameter:
    type: str = ""
    description: str = ""
    unit: str = ""
    default: Any = None

    @classmethod
    def from_dict(cls, d: dict) -> "Parameter":
        return cls(type=d.get("type", ""), description=d.get("desc", ""),
                   unit=d.get("unit", ""), default=d.get("default"))


@dataclass
class TestCase:
    __test__ = False  # not a pytest test class

    name: str
    instances: InstanceConstraints = field(
        default_factory=InstanceConstraints)
    parameters: dict[str, Parameter] = field(default_factory=dict)
    default_instances: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "TestCase":
        inst = d.get("instances", {})
        return cls(
            name=d.get("name", ""),
            instances=InstanceConstraints.from_dict(inst),
            parameters={k: Parameter.from_dict(v)
                        for k, v in d.get("params", {}).items()},
            default_instances=int(inst.get("default", 0)),
        )


@dataclass
class TestPlanManifest:
    __test__ = False  # not a pytest test class

    name: str
    builders: dict[str, dict] = field(default_factory=dict)
    runners: dict[str, dict] = field(default_factory=dict)
    test_cases: list[TestCase] = field(default_factory=list)
    extra_sources: dict[str, list[str]] = field(default_factory=dict)
    defaults: dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "TestPlanManifest":
        return cls(
            name=d.get("name", ""),
            builders=dict(d.get("builders", {})),
            runners=dict(d.get("runners", {})),
            test_cases=[TestCase.from_dict(t) for t in d.get("testcases", [])],
            extra_sources={k: list(v)
                           for k, v in d.get("extra_sources", {}).items()},
            defaults=dict(d.get("defaults", {})),
        )

    @classmethod
    def from_toml(cls, text: str) -> "TestPlanManifest":
        return cls.from_dict(tomllib.loads(text))

    @classmethod
    def load(cls, path) -> "TestPlanManifest":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    def test_case_by_name(self, name: str) -> Optional[TestCase]:
        for tc in self.test_cases:
            if tc.name == name:
                return tc
        return None

    def has_builder(self, name: str) -> bool:
        return name in self.builders

    def has_runner(self, name: str) -> bool:
        return name in self.runners

    def supported_builders(self) -> list[str]:
        return sorted(self.builders)

    def supported_runners(self) -> list[str]:
        return sorted(self.runners)
