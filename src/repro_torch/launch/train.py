"""End-to-end training driver: config, sharded data, train step,
checkpoint/restart, heartbeat and straggler monitors.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_4b \
      --steps 8 --batch 2 --seq 4096

The port of ``repro.launch.train``, plus ``--device`` (default: the card;
``--device cpu`` runs the plain torch path) and ``--impl`` (the attention
pair: ``cuda``, the flash kernels, or ``torch``, their plain versions;
default: by device).  Without ``--reduced`` the architecture runs at its
full width and depth.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.core.device import resolve_device
from repro_torch.data.loader import LoaderConfig, ShardedLoader
from repro_torch.models.frontends import fake_frontend_embeds
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.elastic import HeartbeatMonitor, StragglerMonitor
from repro_torch.train.train_step import init_state, make_train_step


def train(arch: str = "phi4_mini", *, reduced: bool = True, steps: int = 20,
          global_batch: int = 8, seq_len: int = 128, lr: float = 3e-4,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          grad_accum: int = 1, seed: int = 0, log_every: int = 10,
          host_index: int = 0, num_hosts: int = 1,
          config: cfgbase.ModelConfig | None = None, device=None,
          impl: str | None = None) -> dict:
    """Train ``steps`` steps from random weights of ``seed`` (or from the
    newest valid checkpoint in ``ckpt_dir``).  Returns the first and last
    loss, the state, the loss history and each step's wall seconds
    (``seconds``, ending in the loss read back to the host)."""
    dev = resolve_device(device)
    cfg = config or cfgbase.get_config(arch)
    if reduced and config is None:
        cfg = cfgbase.reduced(cfg)
    model = build_model(cfg, impl=impl)

    loader = ShardedLoader(
        LoaderConfig(global_batch=global_batch, seq_len=seq_len,
                     vocab_size=cfg.vocab_size, seed=seed),
        host_index=host_index, num_hosts=num_hosts)

    opt_cfg = opt.AdamWConfig(lr=lr, warmup_steps=max(2, steps // 10),
                              total_steps=steps)
    step_fn = make_train_step(model.loss_fn, opt_cfg, grad_accum=grad_accum)

    # --- restore-or-init (fault tolerance: always resumable) --------------
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    state = init_state(model.init(gen))
    start_step = 0
    if ckpt_dir:
        latest = ckpt.latest_valid(ckpt_dir)
        if latest:
            state = ckpt.restore(latest, state)
            start_step = ckpt.manifest_step(latest)
            # as the JAX driver seeks (one batch a step whatever grad_accum)
            loader.seek(start_step * max(1, grad_accum))
            print(f"resumed from {latest} at step {start_step}")

    hb = HeartbeatMonitor(timeout=120.0)
    straggle = StragglerMonitor()
    pending_save = None
    history, seconds = [], []
    fe = fake_frontend_embeds(cfg, global_batch // num_hosts, device=dev)
    batches = loader.prefetched(dev)
    for step in range(start_step, steps):
        batch = next(batches)
        if fe is not None:
            batch["frontend_embeds"] = fe
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])        # blocks; step wall time is real
        dt = time.perf_counter() - t0
        hb.beat(f"host{host_index}", step)
        straggle.record(f"host{host_index}", dt)
        history.append(loss)
        seconds.append(dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f} ms")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending_save is not None:
                pending_save.wait()          # surfaces async writer errors
            pending_save = ckpt.save(ckpt_dir, step + 1, state,
                                     blocking=False)
        if not np.isfinite(loss):
            raise RuntimeError(f"loss diverged at step {step}")
    if pending_save is not None:
        pending_save.wait()
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, state, blocking=True)
    return dict(first_loss=history[0], last_loss=history[-1],
                state=state, history=history, seconds=seconds)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4_mini",
                    choices=list(cfgbase.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain torch path")
    ap.add_argument("--impl", default=None, choices=("cuda", "torch"),
                    help="the attention pair (default: by device)")
    args = ap.parse_args()
    out = train(args.arch, reduced=args.reduced, steps=args.steps,
                global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                grad_accum=args.grad_accum, device=args.device,
                impl=args.impl)
    print(f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}")


if __name__ == "__main__":
    main()
