"""Serving driver: replicas + WS-scheduled engine over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \
      --reduced --requests 16 --slots 4

The port of ``repro.launch.serve``, plus ``--device`` (default: the card;
``--device cpu`` runs the plain torch path).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.core.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Replica, Request, ServingEngine


def build_engine(arch: str = "gemma2_9b", *, reduced: bool = True,
                 n_replicas: int = 1, n_slots: int = 4, max_seq: int = 160,
                 policy: str = "ws", seed: int = 0,
                 config: cfgbase.ModelConfig | None = None, device=None,
                 **kw):
    """(cfg, model, params, engine): weights from ``seed`` on ``device``
    (None: the card), ``n_replicas`` replicas sharing them.  ``config``
    (e.g. a full-width config cut in depth) replaces ``arch`` and
    ``reduced``.  ``kw`` goes to :class:`ServingEngine`."""
    dev = resolve_device(device)
    cfg = config or cfgbase.get_config(arch)
    if reduced and config is None:
        cfg = cfgbase.reduced(cfg)
    model = build_model(cfg)
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    replicas = [Replica(model, params, n_slots=n_slots, max_seq=max_seq,
                        seed=seed + i, device=dev)
                for i in range(n_replicas)]
    return cfg, model, params, ServingEngine(replicas, policy=policy, **kw)


def drain(engine: ServingEngine, requests) -> dict:
    """Submit ``requests``, run the engine until drained; the driver's
    summary (host clock, ending on the tokens read back to the host)."""
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    n_tokens = sum(len(c.tokens) for c in done)
    return dict(completed=len(done), tokens=n_tokens, seconds=dt,
                tok_per_s=n_tokens / dt)


def serve(arch: str = "gemma2_9b", *, reduced: bool = True,
          n_requests: int = 16, n_replicas: int = 1, n_slots: int = 4,
          max_seq: int = 160, max_new: int = 8, policy: str = "ws",
          seed: int = 0, device=None) -> dict:
    cfg, _, _, engine = build_engine(
        arch, reduced=reduced, n_replicas=n_replicas, n_slots=n_slots,
        max_seq=max_seq, policy=policy, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n_requests):
        plen = int(rng.integers(4, max_seq - max_new - 2))
        requests.append(Request(
            uid=i, prompt=rng.integers(1, cfg.vocab_size, plen
                                       ).astype(np.int32),
            max_new_tokens=max_new))
    return drain(engine, requests)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_9b",
                    choices=list(cfgbase.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="ws", choices=("ws", "drr", "od"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    out = serve(args.arch, reduced=args.reduced, n_requests=args.requests,
                n_replicas=args.replicas, n_slots=args.slots,
                policy=args.policy, device=args.device)
    print(f"{out['completed']} requests, {out['tokens']} tokens in "
          f"{out['seconds']:.1f}s ({out['tok_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
