"""Optimizers (counterpart of ``mxnet_tpu/optimizer``); ported so far:
SGD (with momentum) and Adam."""
from .optimizer import (SGD, Adam, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]
