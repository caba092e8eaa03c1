from .corpus import SyntheticCorpus
from .loader import ShardLoader, phase_batches
from .sharder import PreShardedDataset, shard_documents

__all__ = ["PreShardedDataset", "ShardLoader", "SyntheticCorpus",
           "phase_batches", "shard_documents"]
