"""Serving engines and speculative-decoding drafters."""
from .serving import ContinuousServingEngine, ServingEngine
from .speculative import DraftModelDrafter, NGramDrafter, make_drafter

__all__ = ["ContinuousServingEngine", "ServingEngine", "NGramDrafter",
           "DraftModelDrafter", "make_drafter"]
