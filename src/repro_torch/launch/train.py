"""Training launcher — PyTorch port of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch qwen2.5-32b --steps 100 \\
        [--recipe baseline] [--mesh 2x2] [--smoke] [--device cpu] \\
        [--ckpt-dir DIR] [--ckpt-every N] [--resume]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch ... --mesh 2x2

Runs ``build_train_step`` under ``sharding_ctx(mesh, recipe)`` with the
state placed by ``param_shardings``, as the reference's launcher does.  The
mesh spans the ranks of the process group: under ``torchrun`` each rank
reads its rank, the world size and the rendezvous from the environment and
takes the card of its ``LOCAL_RANK``; a lone process runs on a 1×1 mesh
over a group of one.  ``--mesh DATAxMODEL`` shapes the ("data", "model")
mesh (default: the world size × 1).  Devices are the card unless
``--device cpu`` is given (gloo; with no card it raises, never switching to
the CPU on its own as the reference does on a CPU host).  ``--smoke`` runs
the reduced same-family config at batch 4, sequence 128.  ``--recipe``
takes the reference's six recipe names; ``--multi-pod`` (the pod axis)
raises until ROADMAP A9.2.  An arch with a layer kind whose distributed
path is not ported yet (MoE, MLA, recurrent, rwkv, whisper's
cross-attention: A9.2) trains without a mesh as one process, and raises
under more than one.

Fault tolerance: checkpoints every ``--ckpt-every`` steps (async, atomic,
retained K=3); on restart with ``--resume`` the state and the data stream
continue from the newest checkpoint, so no batch repeats.

:func:`train_loop` is the loop itself, callable with a config.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import RECIPES, param_shardings
from repro_torch.distributed.ctx import A92, sharding_ctx
from repro_torch.launch.mesh import init_process_group, make_mesh
from repro_torch.models import count_params, model_specs
from repro_torch.models import common as cm
from repro_torch.models.transformer import build_layer_defs, undistributed_kind
from repro_torch.models.common import resolve_device
from repro_torch.training import AdamWConfig, TrainState, build_train_step, init_train_state
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import PrefetchIterator, SyntheticTokenDataset
from repro_torch.training.optimizer import OptState


def place_state(cfg, state: TrainState, mesh, recipe) -> TrainState:
    """``state`` (whole on every rank) as DTensors placed by
    ``param_shardings``; the moments take their parameter's placement.  On
    a mesh of one rank every placement is the whole tensor: the state
    stays as it is, and no op pays DTensor's dispatch."""
    if mesh.size() == 1:
        return state
    shardings = dict(cm.tree_leaves(param_shardings(model_specs(cfg), recipe, mesh)))

    def place(tree):
        return cm.tree_from_paths(tree, {path: shardings[path].distribute(t)
                                         for path, t in cm.tree_leaves(tree)})

    return TrainState(place(state.params),
                      OptState(state.opt.step, place(state.opt.mu), place(state.opt.nu)))


def train_loop(cfg, *, steps: int, batch_size: int, seq: int, device=None,
               hp: AdamWConfig = AdamWConfig(),
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               resume: bool = False, mesh=None, recipe=None,
               log: Callable[[str], None] = print) -> tuple[TrainState, List[Dict]]:
    """Train ``cfg`` for ``steps`` steps on ``device`` (default: the card);
    with ``mesh`` and ``recipe``, under ``sharding_ctx(mesh, recipe)`` with
    the state placed by ``param_shardings`` (every rank draws the same
    batches and takes its shard).

    Returns the final state and one record per step run: loss, grad_norm,
    moe_aux (the MoE load-balance loss; 0 without experts),
    step_ms (wall time of the step, synchronized with the device), tokens/s
    and the peak device memory so far (GB, on a card)."""
    dev = resolve_device(device)
    data = SyntheticTokenDataset(cfg.vocab_size, seq, batch_size)
    ckpt = CheckpointManager(ckpt_dir, keep=3, async_save=True) if ckpt_dir else None
    sharded = contextlib.ExitStack()
    state = init_train_state(cfg, device=dev)
    if mesh is not None:
        sharded.enter_context(sharding_ctx(mesh, recipe))
        state = place_state(cfg, state, mesh, recipe)
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
        if ckpt is not None:
            save(max(steps, start))
            ckpt.wait()
    finally:
        it.close()
        sharded.close()
    return state, records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--recipe", default="baseline", choices=sorted(RECIPES))
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL sizes of the mesh (default: the world size x 1)")
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

    if args.multi_pod:
        raise NotImplementedError(f"--multi-pod is not ported: {A92}")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    batch_size = args.batch or (4 if args.smoke else 256)
    seq = args.seq or (128 if args.smoke else 4096)
    kind = undistributed_kind(build_layer_defs(cfg))
    owned = kind is None and not dist.is_initialized()
    if kind is None:
        dev = init_process_group(args.device)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1 or args.mesh:
        raise NotImplementedError(f"layer kind {kind!r} on a mesh: {A92}")
    else:
        dev = resolve_device(args.device)
    try:
        mesh, where = None, f"no mesh ({kind!r} layers: {A92})"
        if kind is None:
            shape = (tuple(int(n) for n in args.mesh.split("x")) if args.mesh
                     else (dist.get_world_size(), 1))
            mesh = make_mesh(shape, ("data", "model"), dev)
            where = f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} recipe={args.recipe}"
        quiet = mesh is not None and dist.get_rank() > 0
        log = (lambda s: None) if quiet else (lambda s: print(s, flush=True))
        log(f"arch={cfg.name} params={count_params(cfg) / 1e9:.2f}B device={dev} {where} "
            f"smoke={args.smoke}")
        return train_loop(cfg, steps=args.steps, batch_size=batch_size, seq=seq, device=dev,
                          hp=AdamWConfig(lr=args.lr), ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every, resume=args.resume, mesh=mesh,
                          recipe=RECIPES[args.recipe] if mesh is not None else None, log=log)
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
