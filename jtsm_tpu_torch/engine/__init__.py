from .predictor import Predictor
from .train_loop import TrainState, create_train_state, make_train_step

__all__ = ["Predictor", "TrainState", "create_train_state", "make_train_step"]
