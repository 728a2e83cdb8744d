from .config import PipelineConfig
from .orchestrator import AerialPipeline

__all__ = ["PipelineConfig", "AerialPipeline"]
