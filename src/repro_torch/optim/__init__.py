from .adamw import AdamState, adamw_init, adamw_update, clip_by_global_norm  # noqa: F401
from .schedule import cosine_schedule, linear_warmup  # noqa: F401
