"""Models ported from the JAX package's examples.

``TransformerLM`` is imported on first use, so that
``python -m mxnet_tpu_torch.models.transformer_lm`` runs the module once,
as ``__main__``."""

__all__ = ["TransformerLM"]


def __getattr__(name):
    if name == "TransformerLM":
        from .transformer_lm import TransformerLM
        return TransformerLM
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
