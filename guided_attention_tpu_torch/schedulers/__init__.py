from guided_attention_tpu_torch.schedulers.ddim import (  # noqa: F401
    DDIMSchedule,
    ddim_step,
    make_ddim_schedule,
    renoise,
)
