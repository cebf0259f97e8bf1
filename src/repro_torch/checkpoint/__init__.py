from .ckpt import append_record, read_records  # noqa: F401
