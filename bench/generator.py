"""The one traffic generator: documents, training jobs and request
streams, all from ``--seed`` and a mix file's parameters.

``Corpus`` is a frozen copy of ``repro_torch.data.corpus.SyntheticCorpus``
(the same seed gives the same domain tables), with one addition: the
caller may say which domain each document comes from, so that every
seed draws the same number of documents from each domain.

A mix fixes the request sizes, their domains and their arrival times,
in one schedule; the run's seed picks the corpus and the token contents
(and so, through the router, the paths).  So runs with different seeds
do the same work at the same times, and their spread is the system's,
not the draw's.
"""
from __future__ import annotations

import numpy as np


class Corpus:
    """Documents from ``num_domains`` latent domains, each with its own
    Zipf-permuted unigram table and a bigram permutation followed with
    probability ``bigram_q`` (the copy of ``SyntheticCorpus``)."""

    def __init__(self, vocab_size: int, num_domains: int, seq_len: int,
                 seed: int, bigram_q: float = 0.8, zipf_a: float = 1.2):
        self.vocab_size, self.num_domains = vocab_size, num_domains
        self.seq_len, self.bigram_q = seq_len, bigram_q
        rng = np.random.default_rng(seed)
        base = 1.0 / np.arange(1, vocab_size + 1) ** zipf_a
        self.unigrams, self.perms = [], []
        for _ in range(num_domains):
            perm = rng.permutation(vocab_size)
            self.unigrams.append(base[perm] / base.sum())
            self.perms.append(rng.permutation(vocab_size))

    def documents(self, domains: np.ndarray, rng) -> np.ndarray:
        """One document of ``seq_len`` tokens for each entry of
        ``domains`` -> (n, seq_len) int32."""
        domains = np.asarray(domains)
        docs = np.empty((len(domains), self.seq_len), np.int32)
        for d in range(self.num_domains):
            idx = np.nonzero(domains == d)[0]
            if len(idx) == 0:
                continue
            u = self.unigrams[d] / self.unigrams[d].sum()
            pi = self.perms[d]
            m = len(idx)
            toks = np.empty((m, self.seq_len), np.int64)
            toks[:, 0] = rng.choice(self.vocab_size, size=m, p=u)
            unif = rng.random((m, self.seq_len))
            fresh = rng.choice(self.vocab_size, size=(m, self.seq_len), p=u)
            for t in range(1, self.seq_len):
                toks[:, t] = np.where(unif[:, t] < self.bigram_q,
                                      pi[toks[:, t - 1]], fresh[:, t])
            docs[idx] = toks
        return docs


def balanced(values, n: int, rng) -> np.ndarray:
    """``n`` draws in which every value of ``values`` appears as often as
    ``n`` allows (the remainder from the first values), in an order
    drawn from ``rng``."""
    values = np.asarray(values)
    return rng.permutation(np.resize(values, n))


def corpus_documents(mix: dict, vocab_size: int, n: int, seed: int,
                     *, stream: int = 0, with_domains: bool = False):
    """``n`` documents of ``mix["doc_len"]`` tokens, the same number
    from each domain, drawn from the corpus of ``seed`` (and their
    domains); ``stream`` separates independent draws of one run."""
    corpus = Corpus(vocab_size, mix["num_domains"], mix["doc_len"], seed)
    rng = np.random.default_rng([seed, stream])
    domains = balanced(np.arange(mix["num_domains"]), n, rng)
    docs = corpus.documents(domains, rng)
    return (docs, domains) if with_domains else docs


def request_sizes(mix: dict, n: int) -> tuple:
    """(prompt lengths, new-token counts, domains) of ``n`` requests:
    every pair of ``mix["prompt_lens"]`` x ``mix["max_new"]`` equally
    often, and every domain, in an order drawn from the mix's own
    ``order_seed``: the same schedule of sizes for every run seed."""
    pairs = np.array([(p, m) for p in mix["prompt_lens"]
                      for m in mix["max_new"]])
    rng = np.random.default_rng(mix["order_seed"])
    order = balanced(np.arange(len(pairs)), n, rng)
    domains = balanced(np.arange(mix["num_domains"]), n, rng)
    return pairs[order, 0], pairs[order, 1], domains


def arrival_times(mix: dict, seconds: float) -> np.ndarray:
    """Open-loop arrivals of a Poisson process of ``mix["rate"]`` a
    second over ``seconds``: ``round(rate * seconds)`` times, uniform
    order statistics drawn from the mix's own ``arrival_seed``, so every
    run seed sees the same schedule."""
    n = int(round(mix["rate"] * seconds))
    rng = np.random.default_rng(mix["arrival_seed"])
    return np.sort(rng.uniform(0.0, seconds, size=n))


def requests(mix: dict, vocab_size: int, n: int, seed: int,
             stream: int = 2) -> list:
    """``n`` requests as (prompt int32 array, max_new): sizes and domains
    from ``request_sizes``, each prompt the head of a document of its
    domain drawn from the corpus of the run's seed (draw ``stream``)."""
    plens, news, domains = request_sizes(mix, n)
    corpus = Corpus(vocab_size, mix["num_domains"], mix["doc_len"], seed)
    docs = corpus.documents(domains, np.random.default_rng([seed, stream]))
    return [(docs[i, :plens[i]].copy(), int(news[i])) for i in range(n)]
