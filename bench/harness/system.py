"""The system under test, built from a configuration file: the data made
from the seed, the server built over it, the set-up mutations, the
warm-up.  From the program it takes only ``SearchServer`` and what it
reports."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench.data.manifold import manifold
from bench.harness import traffic as traffic_lib


def _plain(value, seed: int):
    """A configuration value as the program takes it: ``"inf"`` is
    infinity, ``"run"`` the run's seed, a list a tuple."""
    if value == "inf":
        return math.inf
    if value == "run":
        return int(seed)
    if isinstance(value, list):
        return tuple(value)
    return value


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class Data:
    """The corpus and the query set, made from the seed on the device: one
    draw, split in that order."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        ds = config["dataset"]
        self.n_train, self.n_test = int(ds["train"]), int(ds["test"])
        X = manifold(self.n_train + self.n_test, d=int(ds["dim"]),
                     latent=int(ds["latent"]), num_clusters=int(ds["clusters"]),
                     noise=float(ds["noise"]), seed=seed, device=device)
        self.corpus = X[: self.n_train]
        self.queries = X[self.n_train :]
        self.queries_host = self.queries.cpu().numpy()


def truth(traffic: dict, data: Data, seed: int):
    """The benchmark's own account of what the index should hold after
    set-up: (deleted frozen rows, every row the ids address, which are
    alive).  Row i of the corpus is id i; with ``reinsert_deleted`` the
    j-th deleted row comes back as id ``n_train + j``."""
    deleted = traffic_lib.deleted_rows(traffic, data.n_train, seed)
    dev = data.corpus.device
    rows = data.corpus
    if traffic.get("reinsert_deleted") and deleted.size:
        rows = torch.cat([rows, rows[torch.as_tensor(deleted, device=dev)]])
    alive = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
    alive[torch.as_tensor(deleted, device=dev)] = False
    return deleted, rows, alive


class System:
    """``SearchServer`` over the data as the configuration states it, with
    the set-up's deletes and re-inserts applied; ``rows`` / ``alive`` from
    ``truth``."""

    def __init__(self, config: dict, traffic: dict, data: Data, seed: int,
                 device: torch.device):
        from repro_torch.launch.serve import SearchServer

        srv = config["server"]
        cfg = {key: _plain(val, seed) for key, val in config.get("index", {}).items()}
        cfg.update({key: _plain(val, seed) for key, val in config.get("search", {}).items()})
        self.device = device
        sync(device)
        t0 = time.perf_counter()
        self.server = SearchServer(
            data.corpus, engine=srv["engine"], cfg=cfg, live=bool(srv.get("live", False)),
            delta_cap=int(srv.get("delta_cap", 1024)), device=device)
        index = self.server.index
        if hasattr(index, "_flat_view"):
            # the beam's flattened tree is built on first use: part of the build
            index._flat_view()
        sync(device)
        self.build_s = time.perf_counter() - t0
        history = getattr(index, "train_history", None) or {}
        self.stage_seconds = dict(history.get("stage_seconds", {}))

        self.deleted, self.rows, self.alive = truth(traffic, data, seed)
        if self.deleted.size:
            self.server.delete(self.deleted)
            if traffic.get("reinsert_deleted"):
                self.server.upsert(self.rows[data.n_train :].cpu().numpy())

    def bucket(self, traffic: dict) -> int:
        """The padded batch size the closed loop's batches reach."""
        return max(8, pow2ceil(int(traffic["batch"])))

    def warm_up(self, traffic: dict, queries_host: np.ndarray) -> None:
        bucket = self.bucket(traffic)
        rows = np.resize(queries_host, (bucket, queries_host.shape[1]))
        self.server.query(rows, k=int(traffic["k"]), record=False)
        sync(self.device)

    def close(self) -> None:
        """Drop the program's state and give its memory back."""
        self.server = None
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
