from repro_torch.kernels.norm_rope.ops import (  # noqa: F401
    add_rmsnorm, add_rmsnorm_ref, rmsnorm, rmsnorm_ref, rope, rope_ref)
