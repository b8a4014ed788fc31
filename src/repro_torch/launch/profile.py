"""Where the time of the port's inference and training steps goes, on the
GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile [--sparse decoded]

Runs the published Spikingformer-4-256 config (seeded random weights;
``--sparse`` sets its sparse datapath, 'auto' by default) on
batches of 64 images through ``build_prefill_step`` and through
``build_train_step`` (AdamW, warmup-cosine): two warm-up calls of each,
then three under ``torch.profiler``. For each step it prints the wall
time per call, the device time per call summed by kernel name, and the
device's busy share (kernel time over wall time), then one JSON line
with the same numbers. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import registry
from repro_torch.optim import adamw, warmup_cosine

ARCH = "spikingformer-4-256"
BATCH = 64
CALLS = 3
TOP = 12


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile(what: str, sparse: str, call) -> None:
    """Profile ``call(i)`` for i in 2..4 after two warm-up calls."""
    for i in range(2):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + CALLS):
            call(i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / CALLS
    by_kernel = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    per_call = {k: v / 1e3 / CALLS for k, v in by_kernel.items()}
    device_ms = sum(per_call.values())
    print(f"{ARCH} {what}, sparse={sparse!r}, {CALLS} calls x {BATCH} "
          f"images: wall {wall_ms:.3f} ms/call, device {device_ms:.3f} ms/call, "
          f"busy share {device_ms / wall_ms:.3f}")
    for name, ms in sorted(per_call.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    print(json.dumps({"arch": ARCH, "step": what, "batch": BATCH,
                      "sparse": sparse,
                      "wall_ms_per_call": wall_ms,
                      "device_ms_per_call": device_ms,
                      "busy_share": device_ms / wall_ms,
                      "kernels_ms_per_call": per_call,
                      "device": torch.cuda.get_device_name(0)}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sparse", default=None,
                    choices=["tile", "decoded", "auto"],
                    help="the engine's sparse datapath (default: the "
                         "config's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    if args.sparse is not None:
        cfg = cfg.replace(engine=cfg.engine.replace(sparse=args.sparse))
    params = registry.init(cfg, seed=0)
    prefill = build_prefill_step(cfg)
    gen = torch.Generator().manual_seed(1)
    v = cfg.vision
    images = [torch.rand((BATCH, v.img_size, v.img_size, v.in_channels),
                         generator=gen).cuda() for _ in range(CALLS + 2)]
    _profile("prefill", cfg.engine.sparse,
             lambda i: prefill(params, {"images": images[i]}))

    opt = adamw(warmup_cosine(2e-3, 1, CALLS + 2))
    train_step = build_train_step(cfg, opt)
    batch_fn = make_batch_fn(cfg, BATCH)
    batches = [batch_fn(i) for i in range(CALLS + 2)]
    carry = [params, opt.init(params), registry.init_state(cfg)]

    def train(i):
        p, o, _, _, st = train_step(carry[0], carry[1], i, batches[i],
                                    carry[2])
        carry[:] = [p, o, st]
    _profile("train", cfg.engine.sparse, train)


if __name__ == "__main__":
    main()
