"""mxnet_tpu_torch.serving.decode — autoregressive decode engine
(counterpart of ``mxnet_tpu.serving.decode``).

Continuous (iteration-level) batching + a paged KV cache on top of the
CachedOp capture cache: finished sequences leave the fixed-shape decode
step and queued requests join it every iteration, KV memory is a shared
block pool whose usage scales with live tokens, prompts run separately
through a prefill bucket ladder, and tokens stream back per-request with
the serving tier's deadline/backpressure/breaker machinery applied
per-stream.

    from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM
    engine = DecodeEngine(TinyCausalLM(device="cpu"), max_slots=8)
    stream = engine.submit([3, 1, 4], max_new_tokens=16, timeout_ms=5000)
    for token in stream:
        ...                       # tokens arrive as they are decoded
    assert stream.status == "OK"
    engine.stop()

Not ported yet: ``ShardedDecodeModel``, ``decode_mesh``,
``long_context_attention`` and ``expert_sharded_ffn`` (``sharding.py``).
"""
from .adapter import GluonCausalLMAdapter, TinyGluonLM
from .engine import DecodeEngine, DecodeStream
from .kv_cache import PagedKVCache
from .model import TinyCausalLM
from .stats import DecodeStats

__all__ = ["DecodeEngine", "DecodeStream", "PagedKVCache", "TinyCausalLM",
           "DecodeStats", "GluonCausalLMAdapter", "TinyGluonLM"]
