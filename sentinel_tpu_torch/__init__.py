"""sentinel_tpu_torch — Sentinel's admission path in PyTorch and CUDA.

The port of ``sentinel_tpu`` (the JAX package, which stays as the
reference) to PyTorch on an NVIDIA H100.  The same design: request events
are micro-batched into tensors and ONE tick per batch decides them —

    {resource_id, origin, count, ...}[B]  --->  verdict[B], wait_ms[B]

— with the sliding windows, breakers and rule tables resident on the
card, every rule check vectorized over the batch, and the tick's effect
scatters and flow-check read carried by hand-written CUDA kernels
(``ops/fused.py``, ``csrc/fused.cu``).  This package imports torch and
numpy only: never jax, and nothing of ``sentinel_tpu``.

The facade mirrors the reference's (SphU / SphO / Tracer / ContextUtil):

    import sentinel_tpu_torch as st

    st.init()                      # on "cuda"; st.init(device="cpu") for the CPU
    st.load_flow_rules([st.FlowRule(resource="HelloWorld", count=20)])

    try:
        with st.entry("HelloWorld"):
            do_work()
    except st.BlockException:
        handle_rejection()

Ported so far: the admission path with flow (default, rate limiter,
warm-up, occupy-ahead), degrade, authority, system and hot-parameter
(param-flow) rules, the observability planes, the sketch tier for
resources past the exact row space (``sentinel_tpu_torch.sketch``: tail
flow rules, hot-set promotion), the client's host surface (the span
tracer ``sentinel_tpu_torch.obs``, the native host library
``sentinel_tpu_torch.native``, the entry hooks, custom slots and metric
extensions), cluster flow control (``sentinel_tpu_torch.cluster``: the
token service with its device token column, the TCP token server and
client, and the client's cluster mode), and the card's measurement probes
(``sentinel_tpu_torch.probes``).  What is not ported raises
``NotImplementedError`` (see ROADMAP.md).
"""

from sentinel_tpu_torch.core.errors import (
    AuthorityException,
    BlockException,
    DegradeException,
    FlowException,
    ParamFlowException,
    PriorityWaitException,
    SystemBlockException,
)
from sentinel_tpu_torch.core.rules import (
    AUTHORITY_BLACK,
    AUTHORITY_WHITE,
    CB_STRATEGY_ERROR_COUNT,
    CB_STRATEGY_ERROR_RATIO,
    CB_STRATEGY_SLOW_REQUEST_RATIO,
    CONTROL_DEFAULT,
    CONTROL_RATE_LIMITER,
    CONTROL_WARM_UP,
    CONTROL_WARM_UP_RATE_LIMITER,
    GRADE_QPS,
    GRADE_THREAD,
    STRATEGY_CHAIN,
    STRATEGY_DIRECT,
    STRATEGY_RELATE,
    AuthorityRule,
    DegradeRule,
    FlowRule,
    ParamFlowItem,
    ParamFlowRule,
    SystemRule,
)
from sentinel_tpu_torch.core.api import (
    clear_rules,
    context,
    entry,
    entry_async,
    get_client,
    init,
    load_authority_rules,
    load_degrade_rules,
    load_flow_rules,
    load_param_flow_rules,
    load_system_rules,
    register_init_func,
    reset,
    trace,
    try_entry,
)


def __getattr__(name):
    if name == "SentinelClient":
        from sentinel_tpu_torch.runtime.client import SentinelClient

        return SentinelClient
    raise AttributeError(name)
