"""Shared bearer-token auth helpers for the HTTP surfaces.

The port's copy of ``sentinel_tpu/utils/authn.py``.

One implementation serves the command center (transport/http_server.py)
and, once it is ported, the dashboard (dashboard/server.py) so the comparison logic and the
bind-host policy can never drift between them.
"""

from __future__ import annotations

import hmac
from typing import Optional


def normalize_token(token: Optional[str]) -> Optional[str]:
    """Collapse empty/whitespace tokens to None so "auth disabled" is one
    value everywhere (an env var defaulting to "" must not half-enable
    auth: demanding ``Bearer `` while binding as if auth were off)."""
    if token is None or not token.strip():
        return None
    return token


def check_bearer(auth_header: Optional[str], token: Optional[str]) -> bool:
    """True when access is allowed: no token configured, or the supplied
    ``Authorization`` header equals ``Bearer <token>`` (constant-time)."""
    token = normalize_token(token)
    if token is None:
        return True
    # bytes, not str: compare_digest(str) demands ASCII and would raise on
    # an arbitrary client-supplied header
    supplied = (auth_header or "").encode("utf-8", "surrogateescape")
    return hmac.compare_digest(supplied, f"Bearer {token}".encode("utf-8"))


def bearer_header(token: Optional[str]) -> dict:
    """Request headers carrying the token ({} when none configured)."""
    token = normalize_token(token)
    return {} if token is None else {"Authorization": f"Bearer {token}"}


def default_bind_host(host: Optional[str]) -> str:
    """Bind policy shared by all servers: an explicit host wins; otherwise
    loopback.  Configuring a token never WIDENS the bind — going from
    unreachable to token-guarded is a downgrade the operator must opt
    into by passing host='0.0.0.0' explicitly."""
    return host if host is not None else "127.0.0.1"
