"""The traffic generator: every cell's clients read the training CLI's
corpus law, sized by the cell's traffic file.

A frozen copy of ``repro_torch/launch/train.py:client_corpus`` and
``make_batch_fn`` with the helpers they call
(``repro_torch/data/synthetic.py:token_stream``,
``repro_torch/data/partition.py:dirichlet_partition``): one shared
Zipfian token stream with a bigram rule, cut into windows of ``seq``
tokens, the windows grouped by "domain" (``n_domains`` contiguous
stretches of the stream) and split over the clients by Dirichlet
shares, so clients see different mixtures. Round t's batch draws
``batch`` windows a client from ``default_rng((seed, t))``.

The one change from the CLI's code is ``token_stream``'s bigram pass,
written over runs instead of token by token: the same tokens (a test
holds the copy to the CLI's batches), in milliseconds instead of
seconds.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np


def token_stream(n_tokens: int, vocab: int, seed: int) -> np.ndarray:
    """Zipfian unigram tokens; with probability 1/2 a token is instead
    ``(prev * 7 + 3) % vocab`` of the token before it (after that one's
    own rewrite)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks
    p /= p.sum()
    toks = rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
    mask = rng.random(n_tokens) < 0.5
    mask[0] = False
    # depth[i]: how many rewrites in a row end at i (0 where mask is off)
    idx = np.arange(n_tokens)
    last_off = np.maximum.accumulate(np.where(mask, 0, idx))
    depth = idx - last_off
    t64 = toks.astype(np.int64)
    for k in range(1, int(depth.max(initial=0)) + 1):
        at = np.flatnonzero(depth == k)
        t64[at] = (t64[at - 1] * 7 + 3) % vocab
    return t64.astype(np.int32)


def dirichlet_partition(labels: np.ndarray, n_clients: int, dir_alpha: float,
                        seed: int, min_per_client: int) -> List[np.ndarray]:
    """Per-client index arrays: each class's examples split over the
    clients by a Dirichlet(dir_alpha) draw, redrawn until every client
    holds ``min_per_client``."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        idx_by_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet([dir_alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_by_client[client].append(part)
        parts = [np.concatenate(p) for p in idx_by_client]
        if min(len(p) for p in parts) >= min_per_client:
            for p in parts:
                rng.shuffle(p)
            return parts
    raise RuntimeError("dirichlet_partition: could not satisfy min_per_client")


def client_corpus(traffic: dict, vocab: int, seed: int
                  ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """The token stream, its window starts and the clients' shards of
    window ids."""
    seq = traffic["seq"]
    toks = token_stream(traffic["corpus_tokens"], vocab, seed)
    n_windows = (len(toks) - seq - 1) // seq
    starts_all = np.arange(n_windows) * seq
    domain = (starts_all // (len(toks) // traffic["n_domains"])
              ).astype(np.int64)
    parts = dirichlet_partition(domain, traffic["clients"],
                                traffic["dir_alpha"], seed,
                                min_per_client=traffic["batch"])
    return toks, starts_all, parts


def make_batch_fn(traffic: dict, vocab: int, seed: int
                  ) -> Callable[[int], dict]:
    """``batch_fn(t)``: round t's (clients, batch, seq) int32 token
    windows as a numpy array under ``"tokens"``, keyed by the absolute
    round. Every row of a round is a different window: a client draws
    its windows without replacement from its own shard, and the shards
    are disjoint."""
    toks, starts_all, parts = client_corpus(traffic, vocab, seed)
    batch, seq = traffic["batch"], traffic["seq"]

    def batch_fn(t: int) -> dict:
        rng = np.random.default_rng((seed, t))
        out = np.empty((len(parts), batch, seq), np.int32)
        for c, p in enumerate(parts):
            pick = rng.choice(p, size=batch, replace=len(p) < batch)
            for j, w in enumerate(pick):
                s = starts_all[w]
                out[c, j] = toks[s:s + seq]
        return {"tokens": out}

    return batch_fn
