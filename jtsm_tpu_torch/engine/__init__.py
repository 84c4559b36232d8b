from .defaults import DefaultTrainer, default_argument_parser, default_setup, test
from .predictor import Predictor
from .train_loop import TrainState, create_train_state, make_train_step

__all__ = [
    "DefaultTrainer",
    "Predictor",
    "TrainState",
    "create_train_state",
    "default_argument_parser",
    "default_setup",
    "make_train_step",
    "test",
]
