from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline

__all__ = ["DataConfig", "PipelineState", "TokenPipeline"]
