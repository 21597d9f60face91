"""Disaggregated prefill/decode serving (docs/SERVING.md).

``DisaggRouter`` runs a prefill-only tier and a decode tier as two
independent ``FleetRouter`` fleets, handing each stream off at its
first token (K/V pages + sampler state + fencing token); ``Autoscaler``
drives each tier's replica count against p99 TTFT/TPOT SLOs and
KV/queue headroom.  ``serving/traffic.py`` generates the open-loop
load these are measured under.  Counterpart of
``mxnet_tpu/serving/disagg/``."""
from .autoscaler import Autoscaler, TierPolicy
from .router import DisaggRouter, DisaggStats

__all__ = ["Autoscaler", "TierPolicy", "DisaggRouter", "DisaggStats"]
