"""Training launcher: any config the port registers, on one device.

    PYTHONPATH=src_torch python -m repro_torch.launch.train \
        --arch gemma2-2b [--smoke] [--steps N] [--batch B] [--seq S] \
        [--lr LR] [--microbatch K] [--ckpt DIR] [--device cpu]

Port of ``repro.launch.train``.  The FULL config by default, the
reduced one with ``--smoke``; on the card unless ``--device`` names
another device (without a card the default raises).  The same code path
either way: the seeded state, the synthetic token stream, the train
step, the loop with its checkpoints and resume.  The parameters are
replicated on one device: the reference's GSPMD layouts over a pod mesh
are not ported and ``--multi-pod`` is refused (sharding is ROADMAP
Queue 1 item 11d).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from .._device import resolve_device
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data.tokens import SyntheticTokenStream, TokenPipelineSpec
from ..optim import AdamWConfig
from ..train.loop import train_loop
from ..train.steps import TrainConfig, init_train_state, make_train_step

SHARDING = ("the GSPMD layouts and multi-pod meshes are not ported: "
            "ROADMAP Queue 1 item 11d (sharding)")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: " + SHARDING)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error(SHARDING)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr),
                       total_steps=args.steps, warmup_steps=5,
                       microbatch=args.microbatch)
    print(f"arch={cfg.arch_id} layout=replicated (one device) "
          f"mesh={{'data': 1, 'model': 1}} device={dev} steps={args.steps} "
          f"batch={args.batch}x{args.seq}")

    state = init_train_state(cfg, tcfg,
                             torch.Generator(device=dev).manual_seed(0), dev)
    stream = SyntheticTokenStream(TokenPipelineSpec(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))

    def feed():
        for toks, tgts in stream:
            yield {"tokens": torch.from_numpy(toks).to(dev),
                   "targets": torch.from_numpy(tgts).to(dev)}

    hist = train_loop(make_train_step(cfg, tcfg), state, feed(),
                      args.steps, log_every=10, ckpt_dir=args.ckpt)
    if not hist["loss"]:                  # the store already held n_steps
        return
    final = hist["loss"][-1]
    print(f"final loss {final:.4f} "
          f"({'improved' if final < hist['loss'][0] else 'NOT improved'} "
          f"from {hist['loss'][0]:.4f})")


if __name__ == "__main__":
    main()
