"""The LM model zoo (port of ``repro.models``): families dense, audio,
moe, hybrid, vlm and ssm."""
from repro_torch.models.model import (  # noqa: F401
    backbone,
    decode_step,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)
