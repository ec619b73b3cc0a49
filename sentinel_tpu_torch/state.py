"""State carried across between the JAX package and the port.

The JAX package's ``EngineState`` and ``RuleSet`` become numpy with
``jax.tree.map(np.asarray, x)``; ``state_from_numpy`` and
``ruleset_from_numpy`` turn those (nested NamedTuples of arrays, matched
by FIELD NAME) into the port's tensors on ``device``, and ``to_numpy``
goes the other way.  A state run for a while in one package can so be
continued in the other — the tests hold the two against each other that
way.  Nothing here imports the JAX package: it only reads attributes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sentinel_tpu_torch.core import rule_tensors as RT
from sentinel_tpu_torch.core.config import EngineConfig
from sentinel_tpu_torch.ops import engine as E
from sentinel_tpu_torch.ops import rtq as RQ
from sentinel_tpu_torch.ops import window as W

#: the JAX package's "no tail rule" threshold sentinel
RT_TAIL_UNRULED = 2.0e38


def _convert(kind, src, device):
    """Build ``kind`` (a NamedTuple class, possibly nested) from ``src``
    field by field; leaves become tensors on ``device``."""
    fields = {}
    for name in kind._fields:
        leaf = getattr(src, name)
        sub = _SUBTYPES.get((kind, name))
        if sub is not None:
            fields[name] = _convert(sub, leaf, device)
        else:
            fields[name] = torch.as_tensor(np.array(leaf, copy=True)).to(device)
    return kind(**fields)


_SUBTYPES = {
    (E.EngineState, "win_sec"): W.WindowState,
    (E.EngineState, "win_min"): W.WindowState,
    (E.EngineState, "gs"): E.SketchState,
    (E.EngineState, "rtq"): RQ.RtqState,
    (E.RuleSet, "flow"): RT.FlowRuleTensors,
    (E.RuleSet, "degrade"): RT.DegradeRuleTensors,
    (E.RuleSet, "auth"): RT.AuthorityTensors,
    (E.RuleSet, "system"): RT.SystemTensors,
}


def state_from_numpy(cfg: EngineConfig, leaves, device) -> E.EngineState:
    """The port's EngineState from the JAX package's (numpy leaves)."""
    state = _convert(E.EngineState, leaves, device)
    ref = E.init_state(cfg, "meta")
    for (path, got), want in zip(_walk(state), _walk(ref)):
        if tuple(got.shape) != tuple(want[1].shape) or got.dtype != want[1].dtype:
            raise ValueError(
                f"state leaf {path}: {tuple(got.shape)} {got.dtype} does not "
                f"match the config's {tuple(want[1].shape)} {want[1].dtype}"
            )
    return state


def ruleset_from_numpy(cfg: EngineConfig, leaves, device) -> E.RuleSet:
    """The port's RuleSet from the JAX package's (numpy leaves).  The JAX
    ruleset's param and tail tables must be empty: those stages are not
    ported."""
    param = getattr(leaves, "param", None)
    if param is not None and np.asarray(param.enabled).any():
        raise NotImplementedError(
            "not ported to sentinel_tpu_torch yet: param-flow rules "
            "(ROADMAP.md Queue A: param)"
        )
    tail = getattr(leaves, "tail", None)
    if tail is not None and (np.asarray(tail.thr) < RT_TAIL_UNRULED / 2).any():
        raise NotImplementedError(
            "not ported to sentinel_tpu_torch yet: sketch-tail flow rules "
            "(ROADMAP.md Queue A: the sketch tier)"
        )
    return _convert(E.RuleSet, leaves, device)


def _walk(x, path=""):
    if isinstance(x, torch.Tensor):
        yield path, x
        return
    for name, v in zip(x._fields, x):
        yield from _walk(v, f"{path}.{name}" if path else name)


def to_numpy(x) -> NamedTuple:
    """The same nested NamedTuple with every tensor as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return type(x)(*[to_numpy(v) for v in x])


def leaves(x) -> dict:
    """{dotted field path: tensor} of a nested state NamedTuple."""
    return dict(_walk(x))
