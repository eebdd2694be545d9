"""Request-level serving over the port's decode path: a bounded admission
queue (tpudl_torch.serve.queue), the dense fixed-slot and the paged KV
caches with int8 pages, the radix prefix tree and page-granular
migration (tpudl_torch.serve.cache), the multi-tenant adapter pool
(tpudl_torch.serve.lora), speculative decoding
(tpudl_torch.serve.speculate), the continuous-batching engine with its
migration and disaggregation inboxes (tpudl_torch.serve.engine), the
serving fault injection (tpudl_torch.serve.chaos) and the synchronous
Request/Result front end with token streaming (tpudl_torch.serve.api) —
the counterparts of the same modules in tpudl.serve. The router and the
autoscaler are ROADMAP queue A item 16(c)."""

from tpudl_torch.serve import chaos  # noqa: F401
from tpudl_torch.serve.api import (  # noqa: F401
    Request,
    Result,
    ServeSession,
    StreamChunk,
    assert_serving_parity,
)
from tpudl_torch.serve.cache import (  # noqa: F401
    MigrationCompatError,
    MigrationCorruptError,
    PagedKVCache,
    RadixPrefixTree,
    SlotCache,
)
from tpudl_torch.serve.engine import Engine  # noqa: F401
from tpudl_torch.serve.lora import AdapterPool, assert_tenant_parity  # noqa: F401
from tpudl_torch.serve.queue import AdmissionQueue  # noqa: F401
from tpudl_torch.serve.speculate import Speculator  # noqa: F401
