from repro_torch.runtime.trainer import ElasticTrainer, HostState, RuntimeConfig

__all__ = ["ElasticTrainer", "HostState", "RuntimeConfig"]
