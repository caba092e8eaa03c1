from .corpus import SyntheticCorpus

__all__ = ["SyntheticCorpus"]
