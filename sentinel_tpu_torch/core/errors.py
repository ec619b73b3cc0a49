"""Block exception hierarchy.

Mirrors the reference's BlockException subclasses
(sentinel-core/.../slots/block/BlockException.java and its five concrete
subclasses: FlowException, DegradeException, ParamFlowException,
SystemBlockException, AuthorityException), plus PriorityWaitException
(sentinel-core/.../slots/block/flow/PriorityWaitException.java) which in
the reference signals "entry granted after waiting for a future window".

Verdict codes are the wire/tensor representation: the decision kernel
emits an int8 verdict per request; the host maps nonzero codes onto these
exception types.
"""

from __future__ import annotations

# Verdict codes emitted by the decision kernel (int8 tensor values).
PASS = 0
BLOCK_FLOW = 1
BLOCK_DEGRADE = 2
BLOCK_PARAM = 3
BLOCK_SYSTEM = 4
BLOCK_AUTHORITY = 5
# Pass, but the caller must wait `wait_ms` before proceeding (leaky-bucket
# pacing / prioritized occupancy).  Maps to TokenResultStatus.SHOULD_WAIT in
# the reference's cluster protocol.
PASS_WAIT = 6


class BlockException(Exception):
    """Base for all flow-control rejections (reference: BlockException.java)."""

    #: verdict code this exception corresponds to
    code = -1

    def __init__(self, resource: str = "", rule=None, limit_origin: str = "default"):
        super().__init__(f"blocked: {resource}")
        self.resource = resource
        self.rule = rule
        self.limit_origin = limit_origin


class FlowException(BlockException):
    code = BLOCK_FLOW


class DegradeException(BlockException):
    code = BLOCK_DEGRADE


class ParamFlowException(BlockException):
    code = BLOCK_PARAM


class SystemBlockException(BlockException):
    code = BLOCK_SYSTEM


class AuthorityException(BlockException):
    code = BLOCK_AUTHORITY


class PriorityWaitException(Exception):
    """Entry granted after occupying a future window; not a rejection."""

    def __init__(self, wait_ms: int):
        super().__init__(f"priority wait {wait_ms} ms")
        self.wait_ms = wait_ms


#: verdict code -> exception class
EXCEPTION_BY_CODE = {
    BLOCK_FLOW: FlowException,
    BLOCK_DEGRADE: DegradeException,
    BLOCK_PARAM: ParamFlowException,
    BLOCK_SYSTEM: SystemBlockException,
    BLOCK_AUTHORITY: AuthorityException,
}


def exception_for_verdict(code: int, resource: str) -> BlockException:
    """The BlockException instance matching a nonzero verdict code."""
    return EXCEPTION_BY_CODE.get(int(code), BlockException)(resource)


def raise_for_verdict(code: int, resource: str, wait_ms: int = 0) -> None:
    """Raise the BlockException matching a nonzero verdict code."""
    if code == PASS or code == PASS_WAIT:
        return
    raise exception_for_verdict(code, resource)
