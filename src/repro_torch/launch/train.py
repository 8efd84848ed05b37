"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-math-1.5b \
        --steps 200 --batch 16 --seq 256 [--reduced] [--synthetic] \
        [--ckpt path] [--device cuda]

A port of ``repro.launch.train`` on one device (``--device``, default
``cuda``; it raises where CUDA is absent unless ``--device cpu`` is given).
The architectures are the port's registered configs; ``--reduced`` trains
the reduced (smoke) variant of the arch.  Weights start from the seeded
random init; data is the synthetic reasoning task (``--synthetic``) or the
random-token LM stream, prefetched on a host thread.  The reference shards
over a mesh when it sees several devices; that is not ported (multi-GPU is
later work), so the loop runs on the one device it is given.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import TrainConfig, get_config, reduced_config
from repro_torch.data import SyntheticReasoningTask
from repro_torch.data.lm import lm_batches, prefetch
from repro_torch.train import Trainer


def main(argv=None) -> None:
    """CLI entry point (see module docstring for usage)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the arch")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic reasoning task data")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20))
    trainer = Trainer(cfg, tcfg, device=args.device)

    if args.synthetic:
        task = SyntheticReasoningTask(seed=tcfg.seed)
        it = (task.lm_batch(args.batch, args.seq) for _ in iter(int, 1))
    else:
        it = lm_batches(cfg.vocab_size, args.batch, args.seq, seed=tcfg.seed)
    it = prefetch(it)

    t0 = time.time()
    for i, batch in enumerate(it):
        if i >= args.steps:
            break
        m = trainer.step(batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:5d} loss {float(m['loss']):8.4f} "
                  f"gnorm {float(m['grad_norm']):7.3f} "
                  f"lr {float(m['lr']):.2e} [{dt:6.1f}s]", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, trainer.params)
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
