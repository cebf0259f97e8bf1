from .ckpt import Checkpointer, latest_step, restore, save  # noqa: F401
from .ckpt import append_record, read_records  # noqa: F401
