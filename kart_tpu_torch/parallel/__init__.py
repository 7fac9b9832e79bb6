"""Several devices: the mesh (an ordered list of torch.devices), the
key-modulus sharded merge classify, and the routing rule. Counterpart of
kart_tpu's ``parallel/`` package; one process drives every device, as
kart_tpu's single controller does."""

from kart_tpu_torch.parallel.mesh import best_device_count, make_mesh
from kart_tpu_torch.parallel.sharded_diff import partition_block, should_shard

__all__ = ["make_mesh", "best_device_count", "partition_block", "should_shard"]
