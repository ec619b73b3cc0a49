"""Rule definitions.

Python dataclass equivalents of the reference's rule POJOs:

- FlowRule        (sentinel-core/.../slots/block/flow/FlowRule.java)
- DegradeRule     (sentinel-core/.../slots/block/degrade/DegradeRule.java)
- SystemRule      (sentinel-core/.../slots/system/SystemRule.java)
- AuthorityRule   (sentinel-core/.../slots/block/authority/AuthorityRule.java)
- ParamFlowRule   (sentinel-extension/sentinel-parameter-flow-control/
                   .../ParamFlowRule.java:34-83)

``to_dict``/``from_dict`` use the reference's camelCase JSON field names so
rule payloads round-trip with Sentinel dashboards / datasources unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# ---- enums (values match the reference's RuleConstant.java) ----------------

GRADE_THREAD = 0  # FLOW_GRADE_THREAD
GRADE_QPS = 1  # FLOW_GRADE_QPS

STRATEGY_DIRECT = 0
STRATEGY_RELATE = 1
STRATEGY_CHAIN = 2

CONTROL_DEFAULT = 0
CONTROL_WARM_UP = 1
CONTROL_RATE_LIMITER = 2
CONTROL_WARM_UP_RATE_LIMITER = 3

CB_STRATEGY_SLOW_REQUEST_RATIO = 0  # DEGRADE_GRADE_RT
CB_STRATEGY_ERROR_RATIO = 1  # DEGRADE_GRADE_EXCEPTION_RATIO
CB_STRATEGY_ERROR_COUNT = 2  # DEGRADE_GRADE_EXCEPTION_COUNT

AUTHORITY_WHITE = 0
AUTHORITY_BLACK = 1

LIMIT_APP_DEFAULT = "default"
LIMIT_APP_OTHER = "other"

# System rule "not set" sentinel (SystemRuleManager treats negatives as off)
_UNSET = -1.0


def _camel(d: Dict[str, Any], **kv) -> Dict[str, Any]:
    d.update(kv)
    return d


@dataclass
class FlowRule:
    """QPS / concurrency limit for one resource (FlowRule.java)."""

    resource: str
    count: float = 0.0
    grade: int = GRADE_QPS
    limit_app: str = LIMIT_APP_DEFAULT
    strategy: int = STRATEGY_DIRECT
    ref_resource: str = ""  # for RELATE (resource) / CHAIN (context) strategy
    control_behavior: int = CONTROL_DEFAULT
    warm_up_period_sec: int = 10
    cold_factor: int = 3  # SentinelConfig default cold factor
    max_queueing_time_ms: int = 500
    cluster_mode: bool = False
    cluster_flow_id: int = 0
    cluster_threshold_type: int = 0  # 0=avg-local(per node), 1=global
    cluster_fallback_to_local: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return {
            "resource": self.resource,
            "count": self.count,
            "grade": self.grade,
            "limitApp": self.limit_app,
            "strategy": self.strategy,
            "refResource": self.ref_resource,
            "controlBehavior": self.control_behavior,
            "warmUpPeriodSec": self.warm_up_period_sec,
            "maxQueueingTimeMs": self.max_queueing_time_ms,
            "clusterMode": self.cluster_mode,
            "clusterConfig": {
                "flowId": self.cluster_flow_id,
                "thresholdType": self.cluster_threshold_type,
                "fallbackToLocalWhenFail": self.cluster_fallback_to_local,
            },
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FlowRule":
        cc = d.get("clusterConfig") or {}
        return cls(
            resource=d["resource"],
            count=float(d.get("count", 0)),
            grade=int(d.get("grade", GRADE_QPS)),
            limit_app=d.get("limitApp") or LIMIT_APP_DEFAULT,
            strategy=int(d.get("strategy", STRATEGY_DIRECT)),
            ref_resource=d.get("refResource") or "",
            control_behavior=int(d.get("controlBehavior", CONTROL_DEFAULT)),
            warm_up_period_sec=int(d.get("warmUpPeriodSec", 10)),
            max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 500)),
            cluster_mode=bool(d.get("clusterMode", False)),
            cluster_flow_id=int(cc.get("flowId", 0) or 0),
            cluster_threshold_type=int(cc.get("thresholdType", 0)),
            cluster_fallback_to_local=bool(cc.get("fallbackToLocalWhenFail", True)),
        )

    def is_valid(self) -> bool:
        return bool(self.resource) and self.count >= 0


@dataclass
class DegradeRule:
    """Circuit-breaker rule (DegradeRule.java).

    grade 0: slow-request ratio — ``count`` is max allowed RT in ms,
             ``slow_ratio_threshold`` the trip ratio.
    grade 1: error ratio — ``count`` in [0, 1].
    grade 2: error count — ``count`` is absolute errors in the window.
    """

    resource: str
    grade: int = CB_STRATEGY_SLOW_REQUEST_RATIO
    count: float = 0.0
    time_window: int = 0  # recovery timeout, SECONDS (Java field name)
    min_request_amount: int = 5  # DEFAULT_MIN_REQUEST_AMOUNT (RuleConstant)
    stat_interval_ms: int = 1000
    slow_ratio_threshold: float = 1.0
    limit_app: str = LIMIT_APP_DEFAULT

    def to_dict(self) -> Dict[str, Any]:
        return {
            "resource": self.resource,
            "grade": self.grade,
            "count": self.count,
            "timeWindow": self.time_window,
            "minRequestAmount": self.min_request_amount,
            "statIntervalMs": self.stat_interval_ms,
            "slowRatioThreshold": self.slow_ratio_threshold,
            "limitApp": self.limit_app,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DegradeRule":
        return cls(
            resource=d["resource"],
            grade=int(d.get("grade", 0)),
            count=float(d.get("count", 0)),
            time_window=int(d.get("timeWindow", 0)),
            min_request_amount=int(d.get("minRequestAmount", 5)),
            stat_interval_ms=int(d.get("statIntervalMs", 1000)),
            slow_ratio_threshold=float(d.get("slowRatioThreshold", 1.0)),
            limit_app=d.get("limitApp") or LIMIT_APP_DEFAULT,
        )

    def is_valid(self) -> bool:
        if not self.resource or self.count < 0 or self.time_window <= 0:
            return False
        if self.grade == CB_STRATEGY_ERROR_RATIO and self.count > 1:
            return False
        return True


@dataclass
class SystemRule:
    """Global adaptive-protection thresholds (SystemRule.java).

    Negative means "not set", matching SystemRuleManager.java:68-97.
    """

    highest_system_load: float = _UNSET
    highest_cpu_usage: float = _UNSET
    qps: float = _UNSET
    avg_rt: float = _UNSET
    max_thread: float = _UNSET
    limit_app: str = LIMIT_APP_DEFAULT

    def to_dict(self) -> Dict[str, Any]:
        return {
            "highestSystemLoad": self.highest_system_load,
            "highestCpuUsage": self.highest_cpu_usage,
            "qps": self.qps,
            "avgRt": self.avg_rt,
            "maxThread": self.max_thread,
            "limitApp": self.limit_app,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SystemRule":
        return cls(
            highest_system_load=float(d.get("highestSystemLoad", _UNSET)),
            highest_cpu_usage=float(d.get("highestCpuUsage", _UNSET)),
            qps=float(d.get("qps", _UNSET)),
            avg_rt=float(d.get("avgRt", _UNSET)),
            max_thread=float(d.get("maxThread", _UNSET)),
            limit_app=d.get("limitApp") or LIMIT_APP_DEFAULT,
        )


@dataclass
class AuthorityRule:
    """Origin allow/deny list for a resource (AuthorityRule.java).

    ``limit_app`` is a comma-separated list of origins, matched against
    the caller origin exactly as AuthorityRuleChecker.java:28-54 does.
    """

    resource: str
    limit_app: str = ""
    strategy: int = AUTHORITY_WHITE

    def origins(self) -> List[str]:
        return [o.strip() for o in self.limit_app.split(",") if o.strip()]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "resource": self.resource,
            "limitApp": self.limit_app,
            "strategy": self.strategy,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AuthorityRule":
        return cls(
            resource=d["resource"],
            limit_app=d.get("limitApp") or "",
            strategy=int(d.get("strategy", AUTHORITY_WHITE)),
        )

    def is_valid(self) -> bool:
        return bool(self.resource) and bool(self.origins())


@dataclass
class ParamFlowItem:
    """Per-value threshold exception (ParamFlowItem.java)."""

    object: str = ""
    count: int = 0
    class_type: str = "java.lang.String"

    def to_dict(self) -> Dict[str, Any]:
        return {"object": self.object, "count": self.count, "classType": self.class_type}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParamFlowItem":
        return cls(
            object=str(d.get("object", "")),
            count=int(d.get("count", 0)),
            class_type=d.get("classType") or "java.lang.String",
        )


@dataclass
class ParamFlowRule:
    """Hot-parameter limit (ParamFlowRule.java:34-83)."""

    resource: str
    count: float = 0.0
    grade: int = GRADE_QPS
    param_idx: int = 0
    duration_in_sec: int = 1
    burst_count: int = 0
    max_queueing_time_ms: int = 0
    control_behavior: int = CONTROL_DEFAULT
    param_flow_item_list: List[ParamFlowItem] = field(default_factory=list)
    cluster_mode: bool = False
    cluster_flow_id: int = 0
    limit_app: str = LIMIT_APP_DEFAULT

    def to_dict(self) -> Dict[str, Any]:
        return {
            "resource": self.resource,
            "count": self.count,
            "grade": self.grade,
            "paramIdx": self.param_idx,
            "durationInSec": self.duration_in_sec,
            "burstCount": self.burst_count,
            "maxQueueingTimeMs": self.max_queueing_time_ms,
            "controlBehavior": self.control_behavior,
            "paramFlowItemList": [i.to_dict() for i in self.param_flow_item_list],
            "clusterMode": self.cluster_mode,
            "clusterConfig": {"flowId": self.cluster_flow_id},
            "limitApp": self.limit_app,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParamFlowRule":
        cc = d.get("clusterConfig") or {}
        return cls(
            resource=d["resource"],
            count=float(d.get("count", 0)),
            grade=int(d.get("grade", GRADE_QPS)),
            param_idx=int(d.get("paramIdx", 0)),
            duration_in_sec=int(d.get("durationInSec", 1)),
            burst_count=int(d.get("burstCount", 0)),
            max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 0)),
            control_behavior=int(d.get("controlBehavior", CONTROL_DEFAULT)),
            param_flow_item_list=[
                ParamFlowItem.from_dict(i) for i in d.get("paramFlowItemList") or []
            ],
            cluster_mode=bool(d.get("clusterMode", False)),
            cluster_flow_id=int(cc.get("flowId", 0) or 0),
            limit_app=d.get("limitApp") or LIMIT_APP_DEFAULT,
        )

    def is_valid(self) -> bool:
        return bool(self.resource) and self.count >= 0 and self.duration_in_sec > 0


RULE_TYPES = {
    "flow": FlowRule,
    "degrade": DegradeRule,
    "system": SystemRule,
    "authority": AuthorityRule,
    "param-flow": ParamFlowRule,
}


def rules_to_json_list(rules) -> List[Dict[str, Any]]:
    return [r.to_dict() for r in rules]


def rules_from_json_list(kind: str, items) -> list:
    cls = RULE_TYPES[kind]
    return [cls.from_dict(i) for i in items]
