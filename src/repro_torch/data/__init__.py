from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                       TokenPipeline, make_pipeline)

__all__ = ["DataConfig", "SyntheticCorpus", "TokenPipeline", "make_pipeline"]
