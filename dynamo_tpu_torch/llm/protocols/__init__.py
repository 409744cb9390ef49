from .annotated import Annotated
from .common import (BackendInput, BackendOutput, FinishReason,
                     LLMEngineOutput, OutputOptions, PreprocessedRequest,
                     SamplingOptions, StopConditions)

__all__ = [
    "Annotated", "BackendInput", "BackendOutput", "FinishReason",
    "LLMEngineOutput", "OutputOptions", "PreprocessedRequest",
    "SamplingOptions", "StopConditions",
]
