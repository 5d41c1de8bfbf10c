"""repro_torch.online — serving-scale predictor lifecycle for ATLAS.

  broker     tick-primed memo + cross-client barrier or queue-depth flushes;
             a flush is one pass of the grouped forest kernel on the card
  transport  connector/listener comm layer (inproc:// zero-copy channels,
             tcp:// length-prefixed msgpack/JSON frames)
  server     AsyncBroker: the broker as a service — event-loop serving with
             virtual-time flush scheduling (continuous batching)
  faults     seeded fault plans, fault-injecting comms, client backoff
  registry   versioned, atomic ForestParams store (publish/promote/rollback),
             the JAX package's on-disk layout
  drift      sliding-window drift monitor + incremental refresh control loop
  bench      load-generator CLI: python -m repro_torch.online.bench
"""

from repro_torch.online.broker import (BrokerPredictor, PredictionBroker,
                                       score_groups)
from repro_torch.online.drift import DriftMonitor, OnlineRefresher
from repro_torch.online.registry import ModelRegistry
from repro_torch.online.server import AsyncBroker, BrokerClient
from repro_torch.online.transport import (Comm, CommClosedError,
                                          FrameTooLargeError, Listener,
                                          SyncComm, connect, listen)

__all__ = ["BrokerPredictor", "PredictionBroker", "score_groups",
           "DriftMonitor", "OnlineRefresher", "ModelRegistry",
           "AsyncBroker", "BrokerClient", "Comm", "CommClosedError",
           "FrameTooLargeError", "Listener", "SyncComm", "connect", "listen"]
