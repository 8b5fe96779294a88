from guided_attention_tpu_torch.guidance.spec import GuidanceSpec, build_guidance_spec  # noqa: F401
from guided_attention_tpu_torch.guidance.losses import (  # noqa: F401
    TokenStats,
    compute_loss,
    compute_token_stats,
    group_by_subprompt,
    meets_threshold,
)
