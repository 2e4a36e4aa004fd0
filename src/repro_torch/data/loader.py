"""Sharded, deterministic, resumable LM token pipeline: the port of
``repro.data.loader``.

  * **Determinism** -- batch ``i`` is a pure function of (seed, step), so
    any host can regenerate any shard at any time; a restart never replays
    or skips data.  The rows are byte for byte the JAX loader's: the same
    ``np.random.default_rng((seed, step, row))`` stream.
  * **Shard-by-construction** -- each host makes only its
    ``(host_index, num_hosts)`` slice of the global batch.
  * **Resumability** -- the loader state is one integer (``step``);
    ``seek(step)`` is O(1).
  * **Prefetch overlap** -- :meth:`ShardedLoader.prefetched` copies the next
    batch to the card from pinned memory on a side stream while the current
    one is used (the JAX ``device_put`` double buffer).

The token source is a seeded synthetic corpus shaped like a tokenized one
(Zipf-ish marginals, document boundaries with EOS).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512


class TokenSource:
    """Seeded synthetic corpus: batch index -> token block (pure function)."""

    def __init__(self, cfg: LoaderConfig):
        self.cfg = cfg

    def block(self, step: int, row_lo: int, row_hi: int) -> np.ndarray:
        cfg = self.cfg
        rows = []
        for r in range(row_lo, row_hi):
            rng = np.random.default_rng(
                (cfg.seed, step, r))            # content-addressed by (step,row)
            # Zipf-ish marginals over the vocab, cheap to sample:
            z = rng.zipf(1.3, size=cfg.seq_len + 1).astype(np.int64)
            toks = (z - 1) % (cfg.vocab_size - 1) + 1
            # document boundaries
            n_eos = max(1, (cfg.seq_len + 1) // cfg.mean_doc_len)
            pos = rng.integers(0, cfg.seq_len + 1, size=n_eos)
            toks[pos] = cfg.eos_id
            rows.append(toks)
        return np.stack(rows).astype(np.int32)


@dataclasses.dataclass
class LoaderState:
    step: int = 0


class ShardedLoader:
    """Per-host view of the global batch stream (data-parallel sharding)."""

    def __init__(self, cfg: LoaderConfig, *, host_index: int = 0,
                 num_hosts: int = 1, source: TokenSource | None = None):
        if cfg.global_batch % num_hosts:
            raise ValueError("global batch must divide evenly across hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.rows_per_host = cfg.global_batch // num_hosts
        self.source = source or TokenSource(cfg)
        self.state = LoaderState()

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        return dict(step=self.state.step)

    def load_state_dict(self, d: dict) -> None:
        self.state.step = int(d["step"])

    def seek(self, step: int) -> None:
        self.state.step = int(step)

    # -- iteration -------------------------------------------------------------
    def next_batch(self) -> dict[str, np.ndarray]:
        lo = self.host_index * self.rows_per_host
        block = self.source.block(self.state.step, lo,
                                  lo + self.rows_per_host)
        self.state.step += 1
        return dict(tokens=block[:, :-1], labels=block[:, 1:])

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def prefetched(self, device=None) -> Iterator[dict[str, torch.Tensor]]:
        """Double-buffered iterator of batches on ``device`` (None: the
        card): the next batch is made on the host and its copy from pinned
        memory is queued on a side stream before the current one is
        yielded; the current stream waits for that copy before the batch is
        used."""
        device = torch.device("cuda" if device is None else device)
        if device.type != "cuda":
            for host in self:
                yield {k: torch.as_tensor(v, device=device)
                       for k, v in host.items()}
            return
        side = torch.cuda.Stream(device)

        def put(host):
            with torch.cuda.stream(side):
                return {k: torch.from_numpy(np.ascontiguousarray(v))
                        .pin_memory().to(device, non_blocking=True)
                        for k, v in host.items()}

        it = iter(self)
        nxt = put(next(it))
        while True:
            cur, ready = nxt, side.record_event()
            nxt = put(next(it))                 # enqueue before yielding
            torch.cuda.current_stream(device).wait_event(ready)
            for t in cur.values():
                t.record_stream(torch.cuda.current_stream(device))
            yield cur
