"""Models ported from the JAX package's examples."""
from .transformer_lm import TransformerLM

__all__ = ["TransformerLM"]
