from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticStream

__all__ = ["DataConfig", "Prefetcher", "SyntheticStream"]
