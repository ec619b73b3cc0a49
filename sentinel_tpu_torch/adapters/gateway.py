"""API-gateway adapter common — gateway flow rules over request attributes.

The analog of sentinel-api-gateway-adapter-common (1,914 LoC):

- ``GatewayFlowRule`` limits a *route* or a *custom API group* by QPS,
  optionally keyed by a request attribute (client IP / host / header /
  URL param / cookie) — rule/GatewayFlowRule + GatewayParamFlowItem.
- ``GatewayRuleConverter`` projects each gateway rule onto a ParamFlowRule
  with a per-rule param index (rule/GatewayRuleConverter.java); rules
  without a param item get a synthetic constant parameter so the limit
  applies per-resource.
- ``GatewayParamParser`` extracts the parameter vector for a request
  (GatewayParamParser.java:34-51); values failing the rule's match
  pattern become a NOT_MATCH sentinel that never counts toward the limit.
- ``ApiDefinitionManager`` matches request paths to custom API groups
  (api/ApiDefinition + matchers), the GatewayApiMatcherManager analog.

Engine note: each entry carries ``EngineConfig.param_dims`` hashed
argument lanes (rule_tensors.param_lanes assigns lanes per resource,
gateway rules first).  The first ``param_dims`` DISTINCT param indices on
a resource get independent enforcement; rules whose index loses the lane
assignment are not enforced and log a warning at compile.  Lane 0's value
also feeds cluster-mode token requests.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.core import rules as R

# resource modes (SentinelGatewayConstants)
RESOURCE_MODE_ROUTE_ID = 0
RESOURCE_MODE_CUSTOM_API_NAME = 1

# param parse strategies
PARAM_PARSE_STRATEGY_CLIENT_IP = 0
PARAM_PARSE_STRATEGY_HOST = 1
PARAM_PARSE_STRATEGY_HEADER = 2
PARAM_PARSE_STRATEGY_URL_PARAM = 3
PARAM_PARSE_STRATEGY_COOKIE = 4

# string match strategies (both for params and API path predicates)
PARAM_MATCH_STRATEGY_EXACT = 0
PARAM_MATCH_STRATEGY_PREFIX = 1
PARAM_MATCH_STRATEGY_REGEX = 2
PARAM_MATCH_STRATEGY_CONTAINS = 3

URL_MATCH_STRATEGY_EXACT = 0
URL_MATCH_STRATEGY_PREFIX = 1
URL_MATCH_STRATEGY_REGEX = 2

#: placeholder for "request attribute did not match the rule's pattern" —
#: a value that never equals a real attribute, so it never hits the limit
NOT_MATCH_PARAM = "$NM"
#: synthetic constant param for rules with no param item
DEFAULT_PARAM = "$D"


@dataclass
class GatewayParamFlowItem:
    parse_strategy: int = PARAM_PARSE_STRATEGY_CLIENT_IP
    field_name: str = ""  # header/param/cookie name
    pattern: str = ""
    match_strategy: int = PARAM_MATCH_STRATEGY_EXACT


@dataclass
class GatewayFlowRule:
    resource: str  # route id or API group name
    resource_mode: int = RESOURCE_MODE_ROUTE_ID
    grade: int = R.GRADE_QPS
    count: float = 0.0
    interval_sec: int = 1
    control_behavior: int = R.CONTROL_DEFAULT
    burst: int = 0
    max_queueing_timeout_ms: int = 500
    param_item: Optional[GatewayParamFlowItem] = None


@dataclass
class ApiPredicateItem:
    pattern: str = ""
    match_strategy: int = URL_MATCH_STRATEGY_EXACT


@dataclass
class ApiDefinition:
    api_name: str
    predicate_items: List[ApiPredicateItem] = field(default_factory=list)


@dataclass
class RequestAttributes:
    """Framework-neutral view of one request (the ServerWebExchange /
    HttpServletRequest of the reference parsers)."""

    path: str = "/"
    client_ip: str = ""
    host: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    url_params: Dict[str, str] = field(default_factory=dict)
    cookies: Dict[str, str] = field(default_factory=dict)


def _value_matches(value: str, pattern: str, strategy: int) -> bool:
    if strategy == PARAM_MATCH_STRATEGY_EXACT:
        return value == pattern
    if strategy == PARAM_MATCH_STRATEGY_PREFIX:
        return value.startswith(pattern)
    if strategy == PARAM_MATCH_STRATEGY_REGEX:
        try:
            return re.search(pattern, value) is not None
        except re.error:
            return False
    if strategy == PARAM_MATCH_STRATEGY_CONTAINS:
        return pattern in value
    return False


class GatewayParamParser:
    def parse_value(self, item: GatewayParamFlowItem, req: RequestAttributes) -> str:
        s = item.parse_strategy
        if s == PARAM_PARSE_STRATEGY_CLIENT_IP:
            value = req.client_ip
        elif s == PARAM_PARSE_STRATEGY_HOST:
            value = req.host
        elif s == PARAM_PARSE_STRATEGY_HEADER:
            value = req.headers.get(item.field_name, "")
        elif s == PARAM_PARSE_STRATEGY_URL_PARAM:
            value = req.url_params.get(item.field_name, "")
        elif s == PARAM_PARSE_STRATEGY_COOKIE:
            value = req.cookies.get(item.field_name, "")
        else:
            value = ""
        value = value or ""
        if item.pattern and not _value_matches(value, item.pattern, item.match_strategy):
            return NOT_MATCH_PARAM
        return value

    def parse(
        self, rules: Sequence[GatewayFlowRule], req: RequestAttributes
    ) -> List[str]:
        """Parameter vector ordered by the rules' assigned indices —
        GatewayParamParser.parseParameterFor."""
        out = []
        for rule in rules:
            if rule.param_item is None:
                out.append(DEFAULT_PARAM)
            else:
                out.append(self.parse_value(rule.param_item, req))
        return out


def convert_to_param_rule(rule: GatewayFlowRule, idx: int) -> R.ParamFlowRule:
    """GatewayRuleConverter.applyToParamRule analog."""
    return R.ParamFlowRule(
        resource=rule.resource,
        count=rule.count,
        grade=rule.grade,
        param_idx=idx,
        duration_in_sec=rule.interval_sec,
        burst_count=rule.burst,
        control_behavior=rule.control_behavior,
        max_queueing_time_ms=rule.max_queueing_timeout_ms,
        param_flow_item_list=[
            # the NOT_MATCH placeholder gets an unlimited exception slot so
            # unmatched requests are not throttled by this rule
            R.ParamFlowItem(object=NOT_MATCH_PARAM, count=1_000_000_000)
        ],
    )


class ApiDefinitionManager:
    """Custom API groups; match(path) returns every group the path joins."""

    def __init__(self):
        self._defs: List[ApiDefinition] = []

    def load(self, defs: Sequence[ApiDefinition]) -> None:
        self._defs = list(defs)

    def get(self) -> List[ApiDefinition]:
        return list(self._defs)

    def match(self, path: str) -> List[str]:
        out = []
        for d in self._defs:
            for item in d.predicate_items:
                ok = (
                    path == item.pattern
                    if item.match_strategy == URL_MATCH_STRATEGY_EXACT
                    else path.startswith(item.pattern)
                    if item.match_strategy == URL_MATCH_STRATEGY_PREFIX
                    else _safe_regex(item.pattern, path)
                )
                if ok:
                    out.append(d.api_name)
                    break
        return out


def _safe_regex(pattern: str, path: str) -> bool:
    try:
        return re.search(pattern, path) is not None
    except re.error:
        return False


class GatewayRuleManager:
    """Holds gateway rules; projects them to param-flow rules on the
    client's dedicated gateway manager (GatewayRuleManager.java +
    GatewayFlowSlot wiring)."""

    def __init__(self, client):
        self.client = client
        self._rules: List[GatewayFlowRule] = []
        self._by_resource: Dict[str, List[GatewayFlowRule]] = {}
        self.parser = GatewayParamParser()

    def load_rules(self, rules: Sequence[GatewayFlowRule]) -> None:
        self._rules = list(rules)
        by_res: Dict[str, List[GatewayFlowRule]] = {}
        for r in self._rules:
            by_res.setdefault(r.resource, []).append(r)
        self._by_resource = by_res
        converted = []
        for res, group in by_res.items():
            for idx, r in enumerate(group):
                converted.append(convert_to_param_rule(r, idx))
        self.client.gateway_param_rules.load(converted)

    def get_rules(self) -> List[GatewayFlowRule]:
        return list(self._rules)

    def params_for(self, resource: str, req: RequestAttributes) -> Optional[List[str]]:
        group = self._by_resource.get(resource)
        if not group:
            return None
        return self.parser.parse(group, req)


class GatewayAdapter:
    """Request-level entry helper shared by the route adapters
    (spring-cloud-gateway / zuul analog): enters the route resource AND
    every matching custom API group, with parsed params."""

    def __init__(
        self,
        client,
        rules: GatewayRuleManager = None,
        apis: ApiDefinitionManager = None,
        origin_fn: Optional[Callable[[RequestAttributes], str]] = None,
    ):
        self.client = client
        self.rules = rules or GatewayRuleManager(client)
        self.apis = apis or ApiDefinitionManager()
        # origin is OPT-IN: client IPs are unbounded-cardinality, so using
        # them as origins would churn through the interned-origin budget;
        # pass origin_fn explicitly when callers are a bounded set
        self.origin_fn = origin_fn

    def entries_for(self, route_id: str, req: RequestAttributes):
        """Yield entries (route first, then API groups); raises
        BlockException after exiting already-acquired entries."""
        resources = [route_id] + self.apis.match(req.path)
        origin = self.origin_fn(req) if self.origin_fn is not None else ""
        entries = []
        try:
            for res in resources:
                args = self.rules.params_for(res, req)
                entries.append(
                    self.client.entry(res, inbound=True, args=args, origin=origin)
                )
        except Exception:
            for e in reversed(entries):
                e.exit()
            raise
        return entries
