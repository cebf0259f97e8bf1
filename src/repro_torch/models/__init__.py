from .registry import Model, build_model  # noqa: F401
