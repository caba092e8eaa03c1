"""``attn_bwd_roofline.train`` read in the dense training cell, whose rate is
``train_tokens_per_s.dense``."""
from bench.harness import reader

read = reader("attn_bwd_roofline.train")
