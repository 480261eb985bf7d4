"""Training launcher with the fault-tolerance supervisor in the loop (port of
``repro/launch/train.py``: the LM, recsys and GNN families).

The loop is JAX's: a batch per step, the NaN guard (a non-finite loss drops
the step's update; a run of them restores the last checkpoint), the
straggler log, an ``AsyncCheckpointer`` save every ``--ckpt-every`` steps
and ``--resume``.  Reduced configs (``build(..., reduced=False)`` gives the
published widths); the card by default, the CPU only when asked:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch fm --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora --steps 5 --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.tokens import TokenStream, recsys_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import gnn
from repro_torch.models import params as params_lib
from repro_torch.models import recsys, transformer
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as steps
from repro_torch.train.fault import Supervisor, SupervisorConfig


def build(arch: str, *, reduced: bool = True, seq_len: int = 64, batch: int = 8,
          device: DeviceLike = None):
    """(params, optimizer state, step, batches) for ``arch``, as JAX's
    ``build``: weights from a generator seeded with 0 on ``device``
    (default CUDA).  LM: AdamW at 3e-4, ``batches(t)`` the step-t
    ``TokenStream(vocab, seq_len, batch)`` batch.  Recsys: AdamW at 1e-3,
    ``batches(t)`` the step-t ``recsys_batch``.  GNN: a fixed random graph
    of 200 nodes, 16 features and 800 edges from
    ``np.random.default_rng(0)`` (JAX's), AdamW at 1e-2."""
    fam = configs.family(arch)
    dev = resolve_device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    if fam == "lm":
        params = params_lib.init_params(transformer.lm_decls(cfg), generator=gen, device=dev)
        opt = opt_lib.adamw(3e-4)
        stream = TokenStream(cfg.vocab_size, seq_len, batch)

        def batches(t: int) -> dict:
            return {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(t).items()}
    elif fam == "recsys":
        params = params_lib.init_params(recsys.recsys_decls(cfg), generator=gen, device=dev)
        opt = opt_lib.adamw(1e-3)
        vocabs = cfg.vocabs[: cfg.n_sparse]

        def batches(t: int) -> dict:
            return {k: torch.as_tensor(v, device=dev)
                    for k, v in recsys_batch(t, batch, vocabs).items()}
    elif fam == "gnn":
        n, d, E = 200, 16, 800
        g = np.random.default_rng(0)
        params = params_lib.init_params(gnn.gcn_decls(cfg, d), generator=gen, device=dev)
        opt = opt_lib.adamw(1e-2)
        x = g.normal(size=(n, d)).astype(np.float32)
        edges = g.integers(0, n, size=(2, E)).astype(np.int32)
        labels = g.integers(0, cfg.num_classes, size=n).astype(np.int32)
        fixed = {k: torch.as_tensor(v, device=dev)
                 for k, v in {"x": x, "edges": edges, "labels": labels}.items()}

        def batches(t: int) -> dict:
            return fixed
    else:
        raise KeyError(arch)
    step = steps.make_train_step(cfg, fam, opt)
    return params, opt.init(params), step, batches


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    help="an LM (smollm-135m, gemma-2b, ...), recsys or GNN arch")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    params, state, step_fn, batches = build(args.arch, seq_len=args.seq_len,
                                            batch=args.batch, device=dev)
    sup = Supervisor(SupervisorConfig())
    saver = ckpt_lib.AsyncCheckpointer(args.ckpt_dir)
    start = 0
    if args.resume and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        (params, state), start = ckpt_lib.restore(args.ckpt_dir, (params, state),
                                                  device=dev)
        print(f"resumed from step {start}")

    for t in range(start, args.steps):
        t0 = time.time()
        batch = batches(t)
        new_params, new_state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.time() - t0
        verdict = sup.observe_loss(loss)
        if verdict == "restore":
            (params, state), t = ckpt_lib.restore(args.ckpt_dir, (params, state),
                                                  device=dev)
            print(f"[fault] non-finite loss run — restored step {t}")
            continue
        if verdict == "skip":
            # the step's update is dropped (JAX's loop adopts it before the
            # guard reads the loss; see ROADMAP Queue 3)
            print(f"[fault] step {t}: non-finite loss, update skipped")
            continue
        params, state = new_params, new_state
        pace = sup.observe_step_time(dt)
        if pace != "ok":
            print(f"[fault] step {t}: {pace} ({dt:.2f}s)")
        if t % 10 == 0 or t == args.steps - 1:
            print(f"step {t}: loss={loss:.4f} ({dt*1e3:.0f} ms)")
        if args.ckpt_every and t and t % args.ckpt_every == 0:
            saver.save(t, (params, state))
    saver.wait()
    print("done")


if __name__ == "__main__":
    main()
