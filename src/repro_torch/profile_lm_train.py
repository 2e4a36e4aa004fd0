"""Device profile of one gemma3_4b training step on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_lm_train

Builds gemma3_4b at full width and depth (34 layers, bf16, random weights
from seed 0) with its optimizer state on the card, as ``chip_smoke.py``
phase 11 does through ``launch.train``, and profiles one training step
(loss, gradients through the flash kernels, AdamW) on the first batch of
B = 2, S = 4,096: once unprofiled after a warm-up step, once under
``torch.profiler``.  Prints one JSON object: the wall time, the device's
busy time and idle share, the device time by kernel group (the flash
forward, the flash backward, matrix products, copies and casts,
everything else) and the costliest kernels and host operators.  It
checks nothing; ``chip_smoke.py`` holds the kernels and the losses.
"""

from __future__ import annotations

import json

from repro_torch.profile_serve import profile_step

ARCH = "gemma3_4b"
SEED = 0
BATCH, SEQ = 2, 4_096
# device kernels by name: the port's flash kernels, cuBLAS's products
# (named nvjet_* on the H100 with CUDA 12.8) and CUTLASS/xmma ones
GROUPS = (("flash_forward", ("flash_fwd",)),
          ("flash_backward", ("flash_bwd",)),
          ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
          ("copy_and_cast", ("copy",)))


def main() -> int:
    import subprocess

    import torch

    from repro_torch.configs import base
    from repro_torch.data.loader import LoaderConfig, ShardedLoader
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_state, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = base.get_config(ARCH)
    model = build_model(cfg)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)
    state = init_state(model.init(gen))
    # launch.train's schedule for an 8-step run
    step_fn = make_train_step(model.loss_fn, opt.AdamWConfig(
        warmup_steps=2, total_steps=8))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in ShardedLoader(
        LoaderConfig(global_batch=BATCH, seq_len=SEQ,
                     vocab_size=cfg.vocab_size, seed=SEED)
    ).next_batch().items()}
    out = profile_step(lambda: step_fn(state, batch), top=15, groups=GROUPS)
    print(json.dumps({"card": card, "arch": ARCH, "batch": BATCH,
                      "seq_len": SEQ, "profile": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
