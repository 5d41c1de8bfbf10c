"""repro_torch.online — serving-scale predictor lifecycle for ATLAS.

  broker     tick-primed memo + cross-client barrier flushes; a flush is
             one pass of the grouped forest kernel on the card
  registry   versioned, atomic ForestParams store (publish/promote/rollback),
             the JAX package's on-disk layout
  drift      sliding-window drift monitor + incremental refresh control loop

The JAX package's transport, server, faults and bench are not ported yet.
"""

from repro_torch.online.broker import (BrokerPredictor, PredictionBroker,
                                       score_groups)
from repro_torch.online.drift import DriftMonitor, OnlineRefresher
from repro_torch.online.registry import ModelRegistry

__all__ = ["BrokerPredictor", "PredictionBroker", "score_groups",
           "DriftMonitor", "OnlineRefresher", "ModelRegistry"]
