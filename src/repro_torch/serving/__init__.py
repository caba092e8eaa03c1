from .engine import EngineOptions, GenerationResult, PathServingEngine

__all__ = ["EngineOptions", "GenerationResult", "PathServingEngine"]
