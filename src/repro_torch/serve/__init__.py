from .async_engine import AsyncEngine, TokenStream  # noqa: F401
from .engine import Engine, ServeConfig  # noqa: F401
from .faults import FaultConfig  # noqa: F401
from .journal import Journal, JournalTap, recover_into, replay  # noqa: F401
from .scheduler import Completion, Request, Scheduler, Status  # noqa: F401
