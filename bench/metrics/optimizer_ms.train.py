"""Train step (``training/train_step.py`` -> ``training/optimizer.py::
update``): the device milliseconds a step of the operations launched under
the span ``train.optimizer``, the global-norm clip and AdamW over every
leaf."""

from bench import spans


def read(window):
    return spans.ms_per_unit(window, "train.optimizer")
