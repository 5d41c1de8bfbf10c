from repro_torch.ml.cv import cross_validate, metrics
from repro_torch.ml.forest import (ForestParams, fit_oblivious_forest,
                                   forest_predict)
from repro_torch.ml.models import ALL_MODELS

__all__ = ["ALL_MODELS", "ForestParams", "cross_validate",
           "fit_oblivious_forest", "forest_predict", "metrics"]
