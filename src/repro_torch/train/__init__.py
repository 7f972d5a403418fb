"""Training substrate: state, step builder, fault-tolerant loop (port of the JAX package's ``repro.train``)."""
from repro_torch.train.state import TrainState, abstract_train_state, make_train_state
from repro_torch.train.step import chunked_cross_entropy, make_loss_fn, make_train_step

__all__ = [
    "TrainState",
    "abstract_train_state",
    "make_train_state",
    "chunked_cross_entropy",
    "make_loss_fn",
    "make_train_step",
]
