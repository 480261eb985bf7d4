"""The benchmark's own copy of the ``manifold`` data generator, frozen here
so that a change to the program cannot change the data it is judged on.

Same design as ``repro_torch.data.synthetic.manifold``: clustered latents
pushed through a fixed random two-layer decoder, plus small ambient noise,
so nearest neighbours follow the latent and are learnable, as real image
embeddings' are.  The decoder (and the cluster means) come from a fixed
seed, the same for every run; the rows come from ``seed``.  The bulk draws
are made on ``device`` with a ``torch.Generator`` in a few large calls, so
a 74 096 x 784 corpus takes a fraction of a second on the card.  A seed
gives the same rows on the same kind of device; the numpy original's rows
are not reproduced.
"""
from __future__ import annotations

import numpy as np
import torch

DECODER_SEED = 99
HIDDEN = 64


def decoder(d: int, latent: int, num_clusters: int):
    """The fixed cluster means (C, latent) and decoder weights W1 (latent,
    64), W2 (64, d), as float32 numpy arrays (the same for every seed)."""
    wrng = np.random.default_rng(DECODER_SEED)
    means = wrng.normal(size=(num_clusters, latent)).astype(np.float32)
    W1 = wrng.normal(size=(latent, HIDDEN)) / np.sqrt(latent)
    W2 = wrng.normal(size=(HIDDEN, d)) / np.sqrt(HIDDEN)
    return means, W1.astype(np.float32), W2.astype(np.float32)


def manifold(n: int, *, d: int, latent: int = 12, num_clusters: int = 20,
             noise: float = 0.02, seed: int, device="cpu") -> torch.Tensor:
    """(n, d) float32 rows on ``device``, deterministic in (n, d, seed,
    device type)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    means, W1, W2 = (torch.as_tensor(a, device=dev)
                     for a in decoder(d, latent, num_clusters))
    labels = torch.randint(0, num_clusters, (n,), generator=gen, device=dev)
    z = means[labels] + 0.5 * torch.randn((n, latent), generator=gen, device=dev)
    X = torch.tanh(z @ W1) @ W2
    X += noise * torch.randn((n, d), generator=gen, device=dev)
    return X
