from .discriminative import DiscriminativeRouter, score_documents
from .features import prefix_features

__all__ = ["DiscriminativeRouter", "prefix_features", "score_documents"]
