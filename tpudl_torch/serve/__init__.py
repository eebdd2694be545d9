"""Request-level serving over the port's decode path: a bounded admission
queue (tpudl_torch.serve.queue), the dense fixed-slot and the paged KV
caches (tpudl_torch.serve.cache), the multi-tenant adapter pool
(tpudl_torch.serve.lora), the continuous-batching engine
(tpudl_torch.serve.engine) and the synchronous Request/Result front end
with token streaming (tpudl_torch.serve.api) — the counterparts of the
same modules in tpudl.serve. The router, autoscaler, the radix and int8
KV tiers, speculation, migration and chaos hooks are not ported yet."""

from tpudl_torch.serve.api import (  # noqa: F401
    Request,
    Result,
    ServeSession,
    StreamChunk,
    assert_serving_parity,
)
from tpudl_torch.serve.cache import PagedKVCache, SlotCache  # noqa: F401
from tpudl_torch.serve.engine import Engine  # noqa: F401
from tpudl_torch.serve.lora import AdapterPool, assert_tenant_parity  # noqa: F401
from tpudl_torch.serve.queue import AdmissionQueue  # noqa: F401
