"""``idle_share.train`` read in the dense training cell, whose rate is
``train_tokens_per_s.dense``."""
from bench.harness import reader

read = reader("idle_share.train")
