"""Synthetic multi-domain corpus (the port's own copy of
``repro/data/corpus.py``: the same seed gives the same documents).

The offline container has no C4; routing experiments need *routable*
structure, so we synthesize documents from ``num_domains`` latent domains.
Each domain d has (a) its own zipf-permuted unigram distribution and
(b) a domain-specific bigram permutation: with probability ``bigram_q``
the next token is ``pi_d(current)``, else it is drawn from the domain
unigram.  Paths that specialize to a domain can therefore reach a much
lower loss than a single generalist of the same size — the property
DiPaCo's coarse routing exploits.
"""
from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    def __init__(self, vocab_size: int = 512, num_domains: int = 8,
                 seq_len: int = 128, seed: int = 0,
                 bigram_q: float = 0.8, zipf_a: float = 1.2):
        self.vocab_size = vocab_size
        self.num_domains = num_domains
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        base = 1.0 / np.arange(1, vocab_size + 1) ** zipf_a
        self.unigrams = []
        self.perms = []
        for d in range(num_domains):
            perm = self.rng.permutation(vocab_size)
            self.unigrams.append((base[perm] / base.sum()).astype(np.float64))
            self.perms.append(self.rng.permutation(vocab_size))
        self.bigram_q = bigram_q

    def sample_documents(self, n: int, *, seed: int | None = None,
                         return_domains: bool = False):
        """-> tokens (n, seq_len) int32 [, domains (n,)]"""
        rng = np.random.default_rng(seed) if seed is not None else self.rng
        domains = rng.integers(0, self.num_domains, size=n)
        docs = np.empty((n, self.seq_len), np.int32)
        for d in range(self.num_domains):
            idx = np.nonzero(domains == d)[0]
            if len(idx) == 0:
                continue
            u = self.unigrams[d]
            pi = self.perms[d]
            m = len(idx)
            toks = np.empty((m, self.seq_len), np.int64)
            toks[:, 0] = rng.choice(self.vocab_size, size=m, p=u / u.sum())
            unif = rng.random((m, self.seq_len))
            fresh = rng.choice(self.vocab_size, size=(m, self.seq_len),
                               p=u / u.sum())
            for t in range(1, self.seq_len):
                follow = unif[:, t] < self.bigram_q
                toks[:, t] = np.where(follow, pi[toks[:, t - 1]],
                                      fresh[:, t])
            docs[idx] = toks.astype(np.int32)
        if return_domains:
            return docs, domains.astype(np.int32)
        return docs

    def oracle_nll(self) -> float:
        """Entropy/token of the generative process (loss lower bound)."""
        h = 0.0
        for d in range(self.num_domains):
            u = self.unigrams[d]
            h_u = -(u * np.log(np.maximum(u, 1e-12))).sum()
            q = self.bigram_q
            h_d = -(q * np.log(q)) - (1 - q) * np.log(max(1 - q, 1e-12)) \
                + (1 - q) * h_u
            h += h_d / self.num_domains
        return float(h)
