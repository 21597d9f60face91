"""Optimizers (counterpart of ``mxnet_tpu/optimizer``): the fourteen
optimizers and the registry's ``Test``, the ``Updater`` and its states
file, which both packages read."""
from .optimizer import (DCASGD, FTML, LBSGD, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, Adamax, Ftrl, Nadam, Optimizer,
                        RMSProp, Signum, Test, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "FTML", "LBSGD", "DCASGD",
           "SGLD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "Updater", "get_updater", "create",
           "register"]

opt = create  # the reference alias mx.optimizer.opt
