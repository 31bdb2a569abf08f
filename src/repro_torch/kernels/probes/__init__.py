from repro_torch.kernels.probes.ops import (  # noqa: F401
    pointer_chase, pointer_chase_ref, tier_copy, tier_copy_ref,
    tier_scatter_add, tier_scatter_add_ref, tier_sum, tier_sum_ref)
