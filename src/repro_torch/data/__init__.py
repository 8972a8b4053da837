from .pipeline import (DataConfig, HeterogeneousTokenPipeline, EpochShuffler,
                       zipf_pmf)

__all__ = ["DataConfig", "HeterogeneousTokenPipeline", "EpochShuffler",
           "zipf_pmf"]
