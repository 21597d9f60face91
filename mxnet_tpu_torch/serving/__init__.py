"""mxnet_tpu_torch.serving — in-process model server (counterpart of
``mxnet_tpu.serving``).

A multi-model, dynamically micro-batched inference server with a fixed
bucket ladder, per-request deadlines, bounded admission with load-shedding
backpressure and per-model circuit breakers, serving ``nn.Module``s on a
CUDA card; above it the serving tier: ``FleetRouter`` over replicas (and
their decode engines), the disaggregated prefill/decode pair
(``disagg``), open-loop traffic (``traffic``) and live weight swaps from
manifest-committed checkpoints (``deploy``).

    from mxnet_tpu_torch import serving
    server = serving.ModelServer()
    server.load_model("lm", net, input_shapes=[((128,), (128,))],
                      dtype=("int32", "int32"))
    result = server.predict("lm", (tokens, positions), timeout_ms=500)
"""
from .buckets import BucketLadder, shape_key
from .batcher import MicroBatcher, Request
from .health import CircuitBreaker, HEALTHY, DEGRADED
from .registry import ModelRegistry, ServableModel
from .server import (ModelServer, InferenceResult,
                     OK, TIMEOUT, OVERLOADED, INVALID_INPUT, ERROR,
                     UNAVAILABLE)
from .fleet import FleetRouter, FleetStats, DecodeFleetStats
from . import decode
from . import deploy
from . import disagg
from . import traffic
from .deploy import DeploymentController

__all__ = ["ModelServer", "InferenceResult", "BucketLadder", "Request",
           "MicroBatcher", "ModelRegistry", "ServableModel", "shape_key",
           "CircuitBreaker", "HEALTHY", "DEGRADED", "decode", "deploy",
           "disagg", "traffic", "DeploymentController",
           "FleetRouter", "FleetStats", "DecodeFleetStats",
           "OK", "TIMEOUT", "OVERLOADED", "INVALID_INPUT", "ERROR",
           "UNAVAILABLE"]
