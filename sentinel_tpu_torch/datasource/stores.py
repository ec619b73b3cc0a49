"""Store-specific datasource bindings over plain HTTP (stdlib only).

Thin stamps of the datasource SPI (datasource/base.py) against the wire
protocols the reference's per-store modules speak through their client
libraries:

  * NacosDataSource        — sentinel-datasource-nacos/.../NacosDataSource.java:1
                             (listener push + initial load; here the open
                             Nacos HTTP API: long-poll listener)
  * ConsulDataSource       — sentinel-datasource-consul/.../ConsulDataSource.java:37
                             (blocking KV queries keyed by X-Consul-Index)
  * ApolloDataSource       — sentinel-datasource-apollo/.../ApolloDataSource.java:1
                             (namespace config + change listener; here the
                             open Apollo HTTP notifications long-poll)
  * EurekaDataSource       — sentinel-datasource-eureka/.../EurekaDataSource.java:1
                             (AutoRefresh poll of instance metadata)
  * EtcdDataSource         — sentinel-datasource-etcd/.../EtcdDataSource.java:1
                             (initial range read + watch; here etcd's
                             JSON/gRPC-gateway: /v3/kv/range + streaming
                             /v3/watch)
  * SpringCloudConfigDataSource — sentinel-datasource-spring-cloud-config
                             (AutoRefresh poll of the config-server JSON)

Each binding feeds the shared DynamicSentinelProperty, so
``RuleManager.register_property`` wires any of them to live rule reloads.
Long-poll/watch loops run on daemon threads and degrade to retry-with-
backoff on transport errors (the reference's client libs behave the same
way); ``close()`` stops them.

The port's copy of ``sentinel_tpu/datasource/stores.py``; it touches no tensor.
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.parse
import urllib.request
from hashlib import md5
from typing import List, Optional

from sentinel_tpu_torch.chaos import failpoints as FP
from sentinel_tpu_torch.datasource.base import AbstractDataSource, AutoRefreshDataSource, Converter

#: chaos failpoint: a raise inside the long-poll/watch loop exercises the
#: error-backoff path of every push-style store binding
_FP_WATCH = FP.register(
    "datasource.store.watch", "push-store long-poll/watch iteration", FP.HIT_ACTIONS
)


def _get(url: str, timeout: float, headers: Optional[dict] = None) -> bytes:
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _record(msg: str, *args, exc: bool = False) -> None:
    from sentinel_tpu_torch.utils.record_log import record_log

    record_log().info(msg, *args, exc_info=exc)


class _PushLoopDataSource(AbstractDataSource):
    """Shared skeleton for push-style stores: initial load + a daemon
    long-poll/watch loop with error backoff."""

    _ERROR_BACKOFF_S = 2.0

    def __init__(self, parser: Converter, name: str):
        super().__init__(parser)
        self._name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _start(self) -> None:
        self._initial_load()
        self._thread = threading.Thread(
            target=self._loop, name=f"sentinel-{self._name}-ds", daemon=True
        )
        self._thread.start()

    def _initial_load(self) -> None:
        try:
            self._property.update_value(self.load_config())
        except Exception:
            _record("[%s] initial load failed", self._name, exc=True)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                FP.hit(_FP_WATCH)
                changed = self._wait_for_change()
                if self._stop.is_set():
                    return
                if changed:
                    self._property.update_value(self.load_config())
            except Exception:
                _record("[%s] watch loop error", self._name, exc=True)
                self._stop.wait(self._ERROR_BACKOFF_S)

    def _wait_for_change(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class NacosDataSource(_PushLoopDataSource):
    """Nacos config push via the open HTTP API.

    Initial GET /nacos/v1/cs/configs, then the official long-poll listener
    (POST /nacos/v1/cs/configs/listener with ``Listening-Configs`` =
    dataId^2group^2md5[^2tenant]^1 and a Long-Pulling-Timeout): a
    non-empty response names the changed configs → re-fetch.  Same
    semantics as the reference's ConfigService listener + loadInitialConfig
    (NacosDataSource.java:1)."""

    def __init__(
        self,
        server_addr: str,  # host:port
        group_id: str,
        data_id: str,
        parser: Converter,
        tenant: str = "",
        poll_timeout_ms: int = 30000,
        http_timeout_s: float = 5.0,
    ):
        if not group_id or not data_id:
            raise ValueError(
                f"Bad argument: groupId=[{group_id}], dataId=[{data_id}]"
            )
        super().__init__(parser, "nacos")
        self.base = f"http://{server_addr}/nacos/v1/cs/configs"
        self.group_id = group_id
        self.data_id = data_id
        self.tenant = tenant
        self.poll_timeout_ms = poll_timeout_ms
        self.http_timeout_s = http_timeout_s
        self._last_md5 = ""
        self._start()

    def read_source(self) -> str:
        q = {"dataId": self.data_id, "group": self.group_id}
        if self.tenant:
            q["tenant"] = self.tenant
        raw = _get(
            self.base + "?" + urllib.parse.urlencode(q), self.http_timeout_s
        ).decode("utf-8")
        self._last_md5 = md5(raw.encode("utf-8")).hexdigest()
        return raw

    def _wait_for_change(self) -> bool:
        fields = [self.data_id, self.group_id, self._last_md5]
        if self.tenant:
            fields.append(self.tenant)
        listening = "\x02".join(fields) + "\x01"
        req = urllib.request.Request(
            self.base + "/listener",
            data=urllib.parse.urlencode(
                {"Listening-Configs": listening}
            ).encode(),
            headers={"Long-Pulling-Timeout": str(self.poll_timeout_ms)},
            method="POST",
        )
        with urllib.request.urlopen(
            req, timeout=self.poll_timeout_ms / 1000.0 + self.http_timeout_s
        ) as r:
            return bool(r.read().strip())


class ConsulDataSource(_PushLoopDataSource):
    """Consul KV with blocking queries (ConsulDataSource.java:37-66): a
    GET /v1/kv/<key>?index=<last>&wait=<n>s hangs until the key changes or
    the wait elapses; a larger X-Consul-Index means new data."""

    def __init__(
        self,
        host: str,
        port: int,
        rule_key: str,
        parser: Converter,
        watch_timeout_s: int = 60,
        http_timeout_s: float = 5.0,
    ):
        super().__init__(parser, "consul")
        self.base = f"http://{host}:{port}/v1/kv/{urllib.parse.quote(rule_key)}"
        self.watch_timeout_s = watch_timeout_s
        self.http_timeout_s = http_timeout_s
        self._last_index = 0
        self._start()

    def _fetch(self, blocking: bool):
        url = self.base
        if blocking:
            url += f"?index={self._last_index}&wait={self.watch_timeout_s}s"
        req = urllib.request.Request(url)
        timeout = (
            self.watch_timeout_s + self.http_timeout_s
            if blocking
            else self.http_timeout_s
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            idx = int(r.headers.get("X-Consul-Index", "0") or 0)
            items = json.loads(r.read().decode("utf-8"))
        value = ""
        if items:
            value = base64.b64decode(items[0].get("Value") or "").decode("utf-8")
        return idx, value

    def read_source(self) -> str:
        idx, value = self._fetch(blocking=False)
        self._last_index = max(self._last_index, idx)
        return value

    def _wait_for_change(self) -> bool:
        idx, _value = self._fetch(blocking=True)
        if idx > self._last_index:
            self._last_index = idx
            return True
        return False


class ApolloDataSource(_PushLoopDataSource):
    """Apollo namespace config with the open HTTP API: initial
    /configfiles/json/<appId>/<cluster>/<namespace>, then the
    /notifications/v2 long poll; ruleKey selects one property inside the
    namespace and defaultRuleValue fills its absence — the reference's
    ConfigChangeListener semantics (ApolloDataSource.java:1)."""

    def __init__(
        self,
        meta_server: str,  # host:port of config service
        app_id: str,
        cluster: str,
        namespace: str,
        rule_key: str,
        default_rule_value: str,
        parser: Converter,
        http_timeout_s: float = 5.0,
    ):
        if not namespace or not rule_key:
            raise ValueError("namespace and ruleKey must be non-empty")
        super().__init__(parser, "apollo")
        self.base = f"http://{meta_server}"
        self.app_id = app_id
        self.cluster = cluster
        self.namespace = namespace
        self.rule_key = rule_key
        self.default_rule_value = default_rule_value
        self.http_timeout_s = http_timeout_s
        self._notification_id = -1
        self._start()

    def read_source(self) -> str:
        url = (
            f"{self.base}/configfiles/json/{self.app_id}/{self.cluster}/"
            f"{self.namespace}"
        )
        cfg = json.loads(_get(url, self.http_timeout_s).decode("utf-8"))
        v = cfg.get(self.rule_key)
        return v if v is not None else self.default_rule_value

    def _wait_for_change(self) -> bool:
        notifications = json.dumps(
            [
                {
                    "namespaceName": self.namespace,
                    "notificationId": self._notification_id,
                }
            ]
        )
        q = urllib.parse.urlencode(
            {
                "appId": self.app_id,
                "cluster": self.cluster,
                "notifications": notifications,
            }
        )
        req = urllib.request.Request(f"{self.base}/notifications/v2?{q}")
        try:
            with urllib.request.urlopen(req, timeout=90.0) as r:
                if r.status == 304:
                    return False
                for n in json.loads(r.read().decode("utf-8")):
                    if n.get("namespaceName") == self.namespace:
                        self._notification_id = n.get(
                            "notificationId", self._notification_id
                        )
                return True
        except urllib.error.HTTPError as ex:
            if ex.code == 304:  # no change within the hold period
                return False
            raise


class EurekaDataSource(AutoRefreshDataSource):
    """Polls an instance's metadata for the rule key
    (EurekaDataSource.java:1): GET {serviceUrl}apps/<appId>/<instanceId>
    with Accept: application/json, falling through the service-url list on
    failure, every refresh_ms (reference default 10 s)."""

    def __init__(
        self,
        app_id: str,
        instance_id: str,
        service_urls: List[str],
        rule_key: str,
        parser: Converter,
        refresh_ms: int = 10000,
        http_timeout_s: float = 5.0,
    ):
        if not app_id or not instance_id or not service_urls or not rule_key:
            raise ValueError("appId/instanceId/serviceUrls/ruleKey required")
        self.app_id = app_id
        self.instance_id = instance_id
        self.service_urls = [
            u if u.endswith("/") else u + "/" for u in service_urls if u
        ]
        self.rule_key = rule_key
        self.http_timeout_s = http_timeout_s
        super().__init__(parser, refresh_ms)
        try:
            self._property.update_value(self.load_config())
        except Exception:
            _record("[eureka] initial load failed", exc=True)

    def read_source(self) -> str:
        last: Optional[Exception] = None
        for base in self.service_urls:
            url = f"{base}apps/{self.app_id}/{self.instance_id}"
            try:
                body = _get(
                    url, self.http_timeout_s, {"Accept": "application/json"}
                )
                inst = json.loads(body.decode("utf-8"))["instance"]
                meta = inst.get("metadata") or {}
                return meta.get(self.rule_key) or ""
            except Exception as ex:  # next replica (reference fallthrough)
                last = ex
        raise last if last else RuntimeError("no eureka service url")


class EtcdDataSource(_PushLoopDataSource):
    """etcd v3 over the JSON/gRPC-gateway (EtcdDataSource.java:1): initial
    POST /v3/kv/range for the key, then a streaming POST /v3/watch whose
    chunked response emits one JSON object per watch event."""

    def __init__(
        self,
        host: str,
        port: int,
        rule_key: str,
        parser: Converter,
        http_timeout_s: float = 5.0,
    ):
        super().__init__(parser, "etcd")
        self.base = f"http://{host}:{port}"
        self.rule_key = rule_key
        self.http_timeout_s = http_timeout_s
        self._start()

    @staticmethod
    def _b64(s: str) -> str:
        return base64.b64encode(s.encode("utf-8")).decode("ascii")

    def read_source(self) -> str:
        req = urllib.request.Request(
            f"{self.base}/v3/kv/range",
            data=json.dumps({"key": self._b64(self.rule_key)}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.http_timeout_s) as r:
            body = json.loads(r.read().decode("utf-8"))
        kvs = body.get("kvs") or []
        if not kvs:
            return ""
        return base64.b64decode(kvs[0].get("value") or "").decode("utf-8")

    def _wait_for_change(self) -> bool:
        payload = json.dumps(
            {"create_request": {"key": self._b64(self.rule_key)}}
        ).encode()
        req = urllib.request.Request(
            f"{self.base}/v3/watch",
            data=payload,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        # streaming read: each line is one watch response; the created
        # handshake has no events, real change notifications do
        with urllib.request.urlopen(req, timeout=3600.0) as r:
            for raw in r:
                if self._stop.is_set():
                    return False
                line = raw.strip()
                if not line:
                    continue
                msg = json.loads(line.decode("utf-8"))
                result = msg.get("result") or msg
                if result.get("events"):
                    return True
        return False


class SpringCloudConfigDataSource(AutoRefreshDataSource):
    """Polls a Spring Cloud Config server's JSON endpoint
    ({server}/{app}/{profile}[/{label}]) and extracts ``rule_key`` from
    the highest-precedence property source — the datasource half of
    sentinel-datasource-spring-cloud-config (which additionally needs a
    bus/refresh event the reference wires through Spring; polling gives
    the same eventual behavior without the Spring runtime)."""

    def __init__(
        self,
        server: str,  # host:port
        app: str,
        profile: str,
        rule_key: str,
        parser: Converter,
        label: str = "",
        refresh_ms: int = 10000,
        http_timeout_s: float = 5.0,
    ):
        self.url = f"http://{server}/{app}/{profile}" + (
            f"/{label}" if label else ""
        )
        self.rule_key = rule_key
        self.http_timeout_s = http_timeout_s
        super().__init__(parser, refresh_ms)
        try:
            self._property.update_value(self.load_config())
        except Exception:
            _record("[spring-cloud-config] initial load failed", exc=True)

    def read_source(self) -> str:
        env = json.loads(_get(self.url, self.http_timeout_s).decode("utf-8"))
        for src in env.get("propertySources") or []:
            v = (src.get("source") or {}).get(self.rule_key)
            if v is not None:
                return v
        return ""
