from repro_torch.models.model import (  # noqa: F401
    active_param_count,
    block_pattern,
    decode_step,
    decode_step_paged,
    forward,
    init_decode_cache,
    init_paged_cache,
    init_params,
    param_count,
)
