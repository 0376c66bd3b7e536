from sgracex1_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_train_state,
    load_train_state_sharded,
    save_checkpoint,
    save_train_state,
    save_train_state_sharded,
)
from sgracex1_tpu_torch.train.loop import (
    History,
    TrainState,
    micro_f1,
    train_graph_classifier,
    train_multilabel_inductive,
    train_node_classifier,
    train_node_classifier_sampled,
)

__all__ = [
    "History",
    "TrainState",
    "train_node_classifier",
    "train_node_classifier_sampled",
    "train_graph_classifier",
    "train_multilabel_inductive",
    "micro_f1",
    "save_checkpoint",
    "load_checkpoint",
    "save_train_state",
    "load_train_state",
    "save_train_state_sharded",
    "load_train_state_sharded",
]
