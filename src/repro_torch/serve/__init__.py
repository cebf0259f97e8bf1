from .engine import Engine, ServeConfig  # noqa: F401
