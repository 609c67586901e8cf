"""Training launcher — PyTorch port of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch rwkv6-7b --steps 100 \\
        [--smoke] [--device cpu] [--ckpt-dir DIR] [--ckpt-every N] [--resume]

Runs ``build_train_step`` on one device: the card unless ``--device cpu``
is given (with no card it raises; it never switches to the CPU on its own,
as the reference does on a CPU host).  ``--smoke`` runs the reduced
same-family config at batch 4, sequence 128.  ``--recipe`` other than
``baseline`` and ``--multi-pod`` shard the state over a mesh in the
reference and raise here until the distributed layer is ported (ROADMAP A9).

Fault tolerance: checkpoints every ``--ckpt-every`` steps (async, atomic,
retained K=3); on restart with ``--resume`` the state and the data stream
continue from the newest checkpoint, so no batch repeats.

:func:`train_loop` is the loop itself, callable with a config.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import count_params
from repro_torch.models.common import resolve_device
from repro_torch.training import AdamWConfig, TrainState, build_train_step, init_train_state
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import PrefetchIterator, SyntheticTokenDataset

_A9 = "ROADMAP A9 (distributed: sharding recipes and meshes)"


def train_loop(cfg, *, steps: int, batch_size: int, seq: int, device=None,
               hp: AdamWConfig = AdamWConfig(),
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               resume: bool = False,
               log: Callable[[str], None] = print) -> tuple[TrainState, List[Dict]]:
    """Train ``cfg`` for ``steps`` steps on ``device`` (default: the card).

    Returns the final state and one record per step run: loss, grad_norm,
    moe_aux (the MoE load-balance loss; 0 without experts),
    step_ms (wall time of the step, synchronized with the device), tokens/s
    and the peak device memory so far (GB, on a card)."""
    dev = resolve_device(device)
    data = SyntheticTokenDataset(cfg.vocab_size, seq, batch_size)
    ckpt = CheckpointManager(ckpt_dir, keep=3, async_save=True) if ckpt_dir else None
    state = init_train_state(cfg, device=dev)
    step_fn = build_train_step(cfg, hp)
    start = 0
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state)
        data.load_state_dict(meta["data"])
        start = meta["step"]
        log(f"resumed at step {start}")

    def save(done: int) -> None:
        # the prefetcher runs ahead of the loop: record the batches consumed
        ckpt.save(done, state, {"data": dict(data.state_dict(), step=done), "step": done})

    records: List[Dict] = []
    it = PrefetchIterator(iter(data))
    try:
        for i, batch in zip(range(start, steps), it):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, {k: torch.from_numpy(v).to(dev, torch.long)
                                             for k, v in batch.items()})
            vals = {k: float(v) for k, v in metrics.items()}      # waits for the step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms = (time.perf_counter() - t0) * 1e3
            rec = dict(step=i, loss=vals["loss"], grad_norm=vals["grad_norm"],
                       moe_aux=vals["moe_aux"],
                       step_ms=step_ms, tokens_per_s=batch_size * seq / (step_ms / 1e3))
            if dev.type == "cuda":
                rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            records.append(rec)
            if i % 10 == 0 or i == steps - 1:
                log(f"step {i:5d} loss={rec['loss']:.4f} gnorm={rec['grad_norm']:.2f} "
                    f"step_ms={step_ms:.1f} tok/s={rec['tokens_per_s']:,.0f}")
            if ckpt is not None and i + 1 < steps and (i + 1) % ckpt_every == 0:
                save(i + 1)
    finally:
        it.close()
    if ckpt is not None:
        save(max(steps, start))
        ckpt.wait()
    return state, records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--recipe", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config at batch 4, sequence 128")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    if args.recipe != "baseline":
        raise NotImplementedError(f"--recipe {args.recipe} is not ported: {_A9}")
    if args.multi_pod:
        raise NotImplementedError(f"--multi-pod is not ported: {_A9}")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    batch_size = args.batch or (4 if args.smoke else 256)
    seq = args.seq or (128 if args.smoke else 4096)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} params={count_params(cfg) / 1e9:.2f}B device={dev} "
          f"recipe={args.recipe} smoke={args.smoke}", flush=True)
    return train_loop(cfg, steps=args.steps, batch_size=batch_size, seq=seq, device=dev,
                      hp=AdamWConfig(lr=args.lr), ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, resume=args.resume,
                      log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
