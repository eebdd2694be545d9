"""Request-level serving over the port's decode path: a bounded admission
queue (tpudl_torch.serve.queue), the dense fixed-slot KV cache
(tpudl_torch.serve.cache), the continuous-batching engine
(tpudl_torch.serve.engine) and the synchronous Request/Result front end
with token streaming (tpudl_torch.serve.api) — the counterparts of the
same modules in tpudl.serve. The router, autoscaler, paged/radix caches,
speculation, adapter serving and chaos hooks are not ported yet."""

from tpudl_torch.serve.api import (  # noqa: F401
    Request,
    Result,
    ServeSession,
    StreamChunk,
    assert_serving_parity,
)
from tpudl_torch.serve.cache import SlotCache  # noqa: F401
from tpudl_torch.serve.engine import Engine  # noqa: F401
from tpudl_torch.serve.queue import AdmissionQueue  # noqa: F401
