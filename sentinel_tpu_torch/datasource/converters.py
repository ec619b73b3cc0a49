"""Standard converters: JSON payloads ↔ typed rule lists.

The port's copy of ``sentinel_tpu/datasource/converters.py``.

The analog of the fastjson converters used throughout the reference demos
(e.g. sentinel-demo-dynamic-file-rule's ``Converter<String, List<FlowRule>>``).
"""

from __future__ import annotations

import json
from typing import Callable, List

from sentinel_tpu_torch.core import rules as R


def json_rule_converter(kind: str) -> Callable[[str], list]:
    """Parser for a JSON array of rules of the given kind
    ("flow" | "degrade" | "system" | "authority" | "param-flow")."""

    def parse(source: str) -> list:
        if not source or not source.strip():
            return []
        return R.rules_from_json_list(kind, json.loads(source))

    return parse


def json_rule_encoder(rules: list) -> str:
    return json.dumps(R.rules_to_json_list(rules), indent=2)
