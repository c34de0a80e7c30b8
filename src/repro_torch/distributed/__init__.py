"""Distributed training helpers of the port: straggler detection and data
shard reassignment (`straggler.py`, the reference's pure logic). The
reference's `compression.py` (the int8 error-feedback all-reduce) comes
with the port's `torch.distributed` mesh, which is not in the port yet."""
from repro_torch.distributed.straggler import ShardAssigner, StragglerDetector

__all__ = ["ShardAssigner", "StragglerDetector"]
