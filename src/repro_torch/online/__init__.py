"""repro_torch.online — the batched prediction broker of the ATLAS predictors.

  broker     tick-primed memo + cross-client barrier/depth flushes; a flush
             is one pass of the grouped forest kernel on the card
"""

from repro_torch.online.broker import (BrokerPredictor, PredictionBroker,
                                       score_groups)

__all__ = ["BrokerPredictor", "PredictionBroker", "score_groups"]
