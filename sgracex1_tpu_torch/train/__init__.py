from sgracex1_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
)
from sgracex1_tpu_torch.train.loop import History, TrainState, train_node_classifier

__all__ = [
    "History",
    "TrainState",
    "train_node_classifier",
    "save_checkpoint",
    "load_checkpoint",
    "save_train_state",
    "load_train_state",
]
