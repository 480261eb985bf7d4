"""Synthetic dataset generators — a copy of ``repro.data.synthetic`` (numpy
only), so the port makes the same data from the same seed without importing
the JAX package.

Distribution-matched stand-ins for the paper's corpora (DESIGN.md §9.4):

* ``fashion_like``  — 784-d mixture of 10 Gaussians with per-class structured
                      means (blocky, non-negative, clipped to [0, 1]), the
                      statistical silhouette of flattened Fashion-MNIST.
* ``glove_like``    — 200-d anisotropic unit vectors in clusters (cosine
                      geometry of word embeddings).
* ``sparse_binary`` — Kosarak-style sparse binary transactions over a large
                      vocabulary with a power-law item distribution (Jaccard).
* ``deep_like``     — 96-d PCA-flavoured descriptors: decaying per-dimension
                      variance (Deep1B geometry).
* ``clustered``     — generic Gaussian mixture for unit tests.

All return float32 numpy arrays and are deterministic in (name, n, seed).
"""
from __future__ import annotations

import numpy as np


def clustered(
    n: int, d: int = 32, *, num_clusters: int = 10, spread: float = 0.3, seed: int = 0
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_clusters, d)).astype(np.float32)
    labels = rng.integers(0, num_clusters, size=n)
    X = means[labels] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return X.astype(np.float32)


def fashion_like(n: int, *, d: int = 784, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(d))
    num_classes = 10
    means = []
    for c in range(num_classes):
        img = np.zeros((side, side), np.float32)
        crng = np.random.default_rng(1000 + c)
        for _ in range(6):  # blocky class template
            r0, c0 = crng.integers(0, side - 6, size=2)
            h, w = crng.integers(4, 12, size=2)
            img[r0 : r0 + h, c0 : c0 + w] += crng.uniform(0.3, 1.0)
        means.append(img.reshape(-1)[:d])
    means = np.stack(means)
    labels = rng.integers(0, num_classes, size=n)
    X = means[labels] + 0.15 * rng.normal(size=(n, d)).astype(np.float32)
    return np.clip(X, 0.0, 1.0).astype(np.float32)


def glove_like(n: int, *, d: int = 200, num_clusters: int = 50, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_clusters, d)).astype(np.float32)
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    labels = rng.integers(0, num_clusters, size=n)
    X = means[labels] + 0.4 * rng.normal(size=(n, d)).astype(np.float32)
    # anisotropic scaling, then renormalize-ish (word vectors aren't unit)
    scales = np.exp(-np.arange(d) / (d / 3)).astype(np.float32)
    return (X * scales).astype(np.float32)


def sparse_binary(
    n: int, *, vocab: int = 2048, avg_items: int = 16, seed: int = 0
) -> np.ndarray:
    """Power-law sparse binary rows (Jaccard experiments)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(1, vocab + 1) ** 1.1)
    p /= p.sum()
    X = np.zeros((n, vocab), np.float32)
    sizes = np.maximum(1, rng.poisson(avg_items, size=n))
    for i in range(n):
        items = rng.choice(vocab, size=min(sizes[i], vocab), replace=False, p=p)
        X[i, items] = 1.0
    return X


def manifold(
    n: int, *, d: int = 96, latent: int = 12, num_clusters: int = 20,
    noise: float = 0.02, seed: int = 0,
) -> np.ndarray:
    """Low-dimensional manifold embedded in R^d (the geometry of real image/
    text embeddings): clustered latents -> fixed random 2-layer decoder ->
    small ambient noise.  Nearest neighbors are determined by the latent,
    so locality is *learnable* — unlike pure-noise Gaussians where NN
    structure is isotropic noise that no compressed index can capture."""
    rng = np.random.default_rng(seed)
    wrng = np.random.default_rng(99)  # decoder fixed across seeds
    means = wrng.normal(size=(num_clusters, latent)).astype(np.float32)
    z = means[rng.integers(0, num_clusters, size=n)] + 0.5 * rng.normal(
        size=(n, latent)
    ).astype(np.float32)
    h = 64
    W1 = wrng.normal(size=(latent, h)).astype(np.float32) / np.sqrt(latent)
    W2 = wrng.normal(size=(h, d)).astype(np.float32) / np.sqrt(h)
    X = np.tanh(z @ W1) @ W2
    X = X + noise * rng.normal(size=(n, d)).astype(np.float32)
    return X.astype(np.float32)


def deep_like(n: int, *, d: int = 96, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    var = np.exp(-np.arange(d) / (d / 4)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32) * np.sqrt(var)
    return X.astype(np.float32)


DATASETS = {
    "clustered": clustered,
    "fashion_like": fashion_like,
    "glove_like": glove_like,
    "sparse_binary": sparse_binary,
    "deep_like": deep_like,
    "manifold": manifold,
}


def make(name: str, n: int, *, seed: int = 0, **kw) -> np.ndarray:
    return DATASETS[name](n, seed=seed, **kw)


def train_query_split(X: np.ndarray, *, query_frac: float = 0.2, seed: int = 0):
    """80/20 index/query split (paper F.1)."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    perm = rng.permutation(n)
    nq = max(1, int(n * query_frac))
    return X[perm[nq:]], X[perm[:nq]]
