"""Dynamic config / property layer (SURVEY.md L4).

The port's copy of ``sentinel_tpu/datasource``: push-based dynamic
rules.  A ``SentinelProperty`` fans values out to typed listeners;
datasources (file poll, in-memory push, HTTP poll, external stores) feed
properties; ``RuleManager.register_property`` subscribes a rule manager
so rule updates flow  datasource → property → manager → engine
recompilation (the reference's tail at DynamicSentinelProperty.java:49 →
FlowPropertyListener.configUpdate).  The store bindings live in
``datasource.stores`` (Nacos, Consul, Apollo, Eureka, etcd, Spring Cloud
Config) and ``datasource.zookeeper``; this package exports what the
reference's exports.
"""

from sentinel_tpu_torch.datasource.base import (
    AbstractDataSource,
    AutoRefreshDataSource,
    Converter,
    FileRefreshableDataSource,
    FileWritableDataSource,
    ReadableDataSource,
    WritableDataSource,
)
from sentinel_tpu_torch.datasource.converters import (
    json_rule_converter,
    json_rule_encoder,
)
from sentinel_tpu_torch.datasource.redis import (
    RedisConnection,
    RedisDataSource,
    RespError,
)
from sentinel_tpu_torch.datasource.remote import CallbackDataSource, HttpDataSource
from sentinel_tpu_torch.datasource.property import (
    DynamicSentinelProperty,
    NoOpSentinelProperty,
    PropertyListener,
    SentinelProperty,
    SimplePropertyListener,
)

__all__ = [
    "SentinelProperty",
    "DynamicSentinelProperty",
    "NoOpSentinelProperty",
    "PropertyListener",
    "SimplePropertyListener",
    "ReadableDataSource",
    "WritableDataSource",
    "AbstractDataSource",
    "CallbackDataSource",
    "HttpDataSource",
    "AutoRefreshDataSource",
    "FileRefreshableDataSource",
    "FileWritableDataSource",
    "Converter",
    "json_rule_converter",
    "json_rule_encoder",
    "RedisConnection",
    "RedisDataSource",
    "RespError",
]
