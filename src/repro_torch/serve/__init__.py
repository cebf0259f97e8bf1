from .engine import Engine, ServeConfig  # noqa: F401
from .scheduler import Completion, Request, Scheduler, Status  # noqa: F401
