from repro_torch.data.pipeline import DataConfig, data_iterator, make_source

__all__ = ["DataConfig", "data_iterator", "make_source"]
