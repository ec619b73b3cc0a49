"""Shared adapter plumbing."""

from __future__ import annotations


def resolve_client(client):
    """The adapter-wide 'explicit client or the process-wide singleton'
    resolution (Env.sph analog), in one place."""
    if client is not None:
        return client
    from sentinel_tpu_torch.core.api import get_client

    return get_client()
