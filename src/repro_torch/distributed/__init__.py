"""Distributed training helpers of the port: the int8 error-feedback
all-reduce (`compression.py`, over a `launch.mesh.Mesh` axis or a
process group; like the reference's, no training path uses it), and
straggler detection and data shard reassignment (`straggler.py`, the
reference's pure logic). The meshes themselves are `launch/mesh.py`."""
from repro_torch.distributed.compression import (
    compress_int8, decompress_int8, error_feedback_init,
    make_compressed_grad_allreduce)
from repro_torch.distributed.straggler import ShardAssigner, StragglerDetector

__all__ = ["ShardAssigner", "StragglerDetector", "compress_int8",
           "decompress_int8", "error_feedback_init",
           "make_compressed_grad_allreduce"]
