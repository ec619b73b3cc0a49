"""Envoy RLS rules: domain + descriptor key/values → cluster flow rules.

The port of ``sentinel_tpu/rls/rules.py`` (no protobuf, no grpcio).  The
reference converts each EnvoyRlsRule resource descriptor into a
sentinel FlowRule keyed by a generated flowId
(sentinel-cluster-server-envoy-rls/.../EnvoySentinelRuleConverter.java,
EnvoyRlsRule/EnvoyRlsRuleManager).  The identifier is the domain plus the
sorted ``key:value`` pairs, so a ShouldRateLimit descriptor maps to the
same id the rule produced.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.core import rules as R


@dataclass
class RlsKeyValue:
    key: str
    value: str = ""


@dataclass
class RlsResourceDescriptor:
    key_values: List[RlsKeyValue] = field(default_factory=list)
    count: float = 0.0


@dataclass
class EnvoyRlsRule:
    domain: str
    descriptors: List[RlsResourceDescriptor] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "EnvoyRlsRule":
        return cls(
            domain=d["domain"],
            descriptors=[
                RlsResourceDescriptor(
                    key_values=[
                        RlsKeyValue(kv["key"], kv.get("value", ""))
                        for kv in r.get("keyValues", [])
                    ],
                    count=float(r.get("count", 0)),
                )
                for r in d.get("descriptors", [])
            ],
        )

    def to_dict(self) -> dict:
        return {
            "domain": self.domain,
            "descriptors": [
                {
                    "keyValues": [
                        {"key": kv.key, "value": kv.value} for kv in r.key_values
                    ],
                    "count": r.count,
                }
                for r in self.descriptors
            ],
        }


def descriptor_identifier(domain: str, entries: Sequence[Tuple[str, str]]) -> str:
    """Canonical identity of (domain, descriptor): sorted key:value pairs."""
    pairs = sorted(f"{k}:{v}" for k, v in entries)
    return domain + "|" + ",".join(pairs)


def identifier_flow_id(identifier: str) -> int:
    """Deterministic positive flowId from the identifier (stable across
    processes, unlike Python's salted hash())."""
    return zlib.crc32(identifier.encode("utf-8")) + 1  # avoid 0


class EnvoyRlsRuleManager:
    """Loads EnvoyRlsRules and projects them as cluster flow rules onto a
    DefaultTokenService (namespace = domain, GLOBAL threshold)."""

    def __init__(self, token_service):
        self._svc = token_service
        self._lock = threading.Lock()
        self._rules: List[EnvoyRlsRule] = []
        self._id_by_identifier: Dict[str, int] = {}
        self._loaded_namespaces: set = set()

    def load(self, rules: List[EnvoyRlsRule]) -> None:
        with self._lock:
            self._rules = list(rules)
            # build the lookup aside and publish once: lookup_flow_id reads
            # without the lock, so it must never see a half-populated map
            id_by_identifier: Dict[str, int] = {}
            by_ns: Dict[str, List[R.FlowRule]] = {}
            for rule in rules:
                for desc in rule.descriptors:
                    ident = descriptor_identifier(
                        rule.domain, [(kv.key, kv.value) for kv in desc.key_values]
                    )
                    fid = identifier_flow_id(ident)
                    id_by_identifier[ident] = fid
                    by_ns.setdefault(rule.domain, []).append(
                        R.FlowRule(
                            resource=ident,
                            count=desc.count,
                            cluster_mode=True,
                            cluster_flow_id=fid,
                            cluster_threshold_type=1,  # GLOBAL
                        )
                    )
            # clear namespaces dropped by this push, or their old flow rules
            # stay enforced in the token service forever
            for ns in self._loaded_namespaces - set(by_ns):
                self._svc.flow_rules.load(ns, [])
            for ns, flow_rules in by_ns.items():
                self._svc.flow_rules.load(ns, flow_rules)
            self._loaded_namespaces = set(by_ns)
            self._id_by_identifier = id_by_identifier

    def get(self) -> List[EnvoyRlsRule]:
        return list(self._rules)

    def lookup_flow_id(self, domain: str, entries: Sequence[Tuple[str, str]]) -> Optional[int]:
        return self._id_by_identifier.get(descriptor_identifier(domain, entries))
