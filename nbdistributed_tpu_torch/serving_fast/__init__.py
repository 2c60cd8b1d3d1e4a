"""Host-side serving machinery (counterpart of
``nbdistributed_tpu/serving_fast``): the KV block allocator."""

from .paging import BlockAllocator, BlocksExhausted, blocks_needed

__all__ = ["BlockAllocator", "BlocksExhausted", "blocks_needed"]
