"""The paged KV cache with radix prefix reuse, the port of
``serve/paging``: :mod:`pool` (the refcounted page allocator; page 0 is
the write-off page), :mod:`radix` (the prefix cache and the multi-turn
session store over the pool) and :mod:`engine` (``PagedSlotEngine``,
the slot engine over the pool, and the pool's sizing).
``--serve.paged`` arms it; the dense engine is untouched without it."""

from tensorflow_distributed_tpu_torch.serve.paging.pool import (  # noqa: F401
    GARBAGE_PAGE, PagePool, PoolExhausted)
from tensorflow_distributed_tpu_torch.serve.paging.radix import (  # noqa: F401
    RadixCache)
