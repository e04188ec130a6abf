from repro_torch.kernels import ops, ref
from repro_torch.kernels.mmad import mmad
from repro_torch.kernels.ops import tile_matmul
