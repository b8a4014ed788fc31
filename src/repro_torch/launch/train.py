"""Training loop for the vision family (Spikingformer, CIFAR-Net).

Runs ``build_train_step`` on deterministic synthetic images with AdamW
under a warmup-cosine schedule, as ``repro.launch.train`` does, and
prints the loss of every step; ``--qat int8|int4`` trains
quantization-aware (the loss sees fake-quantized linears, the fp
masters take the straight-through gradients). Checkpointing (ROADMAP queue 1 item 8),
failure injection and the straggler monitor (queue 1 item 10) are still
to be ported.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-4-256 --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-4-256 --steps 6 --batch 64      # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-4-256 --steps 6 --batch 64 --sparse decoded
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-4-256 --steps 6 --batch 64 --qat int8
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch cifarnet --steps 6 --batch 64
"""
from __future__ import annotations

import argparse
from typing import Callable, List, Optional

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import STATEFUL, build_train_step
from repro_torch.models import registry
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.tree import tree_leaves


def make_batch_fn(cfg, batch_size: int) -> Callable:
    """step -> numpy batch {'images', 'labels'} of the vision family."""
    if cfg.family not in STATEFUL:
        raise NotImplementedError(
            f"data for the {cfg.family} family is not ported to PyTorch yet "
            f"(ROADMAP queue 1 item 7)")
    data = make_pipeline(DataConfig(
        kind="images", global_batch=batch_size,
        img_size=cfg.vision.img_size, channels=cfg.vision.in_channels,
        num_classes=cfg.vocab_size))
    return data.batch_at


def train(arch: str, smoke: bool, total_steps: int, batch: int, lr: float,
          seed: int = 0, device: DeviceLike = None,
          sparse: Optional[str] = None,
          qat: Optional[str] = None) -> List[float]:
    """Train ``arch`` from random weights (``seed``) for ``total_steps``
    steps; returns the loss of each step. ``sparse`` overrides the
    engine's sparse datapath (tile | decoded | auto); ``qat`` ('int8' |
    'int4') trains quantization-aware."""
    cfg = get_config(arch, smoke=smoke)
    if sparse is not None:
        if cfg.engine is None:
            raise ValueError(f"{arch} has no engine: --sparse does not "
                             f"apply")
        cfg = cfg.replace(engine=cfg.engine.replace(sparse=sparse))
    dev = resolve_device(device)
    opt = adamw(warmup_cosine(lr, max(1, total_steps // 20), total_steps))
    batch_fn = make_batch_fn(cfg, batch)
    step_fn = build_train_step(cfg, opt, qat=qat, device=dev)
    params = registry.init(cfg, seed, device=dev)
    opt_state = opt.init(params)
    model_state = registry.init_state(cfg, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name} ({'smoke' if smoke else 'full'}) on {dev}: "
          f"{n_params / 1e6:.2f}M params, {total_steps} steps, "
          f"batch={batch}{f', qat={qat}' if qat else ''}", flush=True)
    losses = []
    for step in range(total_steps):
        params, opt_state, _, metrics, model_state = step_fn(
            params, opt_state, step, batch_fn(step), model_state)
        losses.append(float(metrics["loss"]))
        print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f} "
              f"fire={float(metrics['fire_rate']):.3f}", flush=True)
    print(f"[train] done: first loss {losses[0]:.4f} last loss "
          f"{losses[-1]:.4f}", flush=True)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ALL_ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--sparse", default=None,
                    choices=["tile", "decoded", "auto"],
                    help="the engine's sparse datapath (default: the "
                         "config's)")
    ap.add_argument("--qat", default=None, choices=["int8", "int4"],
                    help="quantization-aware training: the loss sees "
                         "fake-quantized linears (STE gradients to the fp "
                         "masters; repro_torch.quant.qat)")
    args = ap.parse_args()
    train(args.arch, args.smoke, args.steps, args.batch, args.lr, args.seed,
          args.device, args.sparse, args.qat)


if __name__ == "__main__":
    main()
