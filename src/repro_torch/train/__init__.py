from .step import TrainHParams, make_train_step  # noqa: F401
from .trainer import TrainConfig, Trainer  # noqa: F401
