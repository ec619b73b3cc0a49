"""sentinel_tpu_torch.sketch — the self-adjusting sketch statistics tier.

The port's counterpart of ``sentinel_tpu/sketch/``.  The exact tier
(ops/window.py rows) serves ruled and hot resources; this package tracks
everything else, so the engine enforces flow rules on 1 M+ resources with
bounded error instead of capping at the exact row space:

  salsa.py   SALSA-style self-adjusting counters (arXiv 2102.12531):
             int8 cells packed four to an int32 word that merge with their
             neighbours on saturation, with O(1) windowed reads from
             incrementally maintained running sums (arXiv 1604.02450).

  hotset.py  The host-side hot-set manager: the tick emits the top-K
             sketched resources of each batch by windowed pass estimate
             (the wire's hot block); the manager promotes heavy sketched
             resources into the exact tier and demotes cold promoted rows
             back to the tail, damped by adaptive.degrade.Hysteresis.

The sketch only OVERESTIMATES (count-min collisions, SALSA merges, lazy
bucket expiry), so tail-rule blocks fire early, never late.

``impl_for(cfg)`` picks the engine's sketch module: salsa (the default,
``sketch_salsa=True``) or the seed count-min tier (ops/gsketch.py); both
expose init_sketch / refresh / add / add_dense / estimate /
estimate_plane_mxu over ops/gsketch.SketchConfig.
"""

from __future__ import annotations


def impl_for(cfg):
    """The sketch module for an EngineConfig: salsa (default) or the plain
    count-min seed.  Imported late so ops modules can import this package
    without cycles."""
    if getattr(cfg, "sketch_salsa", False):
        from sentinel_tpu_torch.sketch import salsa

        return salsa
    from sentinel_tpu_torch.ops import gsketch

    return gsketch


__all__ = ["impl_for"]
