from mansy_immersivevideostreaming_torch.parallel.mesh import (
    Mesh, init_distributed, make_mesh, replicate, shard_batch,
)
