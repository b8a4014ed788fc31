"""Where the time of the port's inference step goes, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile

Runs the published Spikingformer-4-256 config (seeded random weights)
through ``build_prefill_step`` on batches of 64 images: two warm-up
requests, then three requests under ``torch.profiler``. Prints
the wall time per request, the device time per request summed by kernel
name, and the device's busy share (kernel time over wall time), then one
JSON line with the same numbers. Needs a CUDA device.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import registry

ARCH = "spikingformer-4-256"
BATCH = 64
REQUESTS = 3
TOP = 12


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    params = registry.init(cfg, seed=0)
    step = build_prefill_step(cfg)
    gen = torch.Generator().manual_seed(1)
    v = cfg.vision
    batches = [{"images": torch.rand((BATCH, v.img_size, v.img_size,
                                      v.in_channels), generator=gen).cuda()}
               for _ in range(REQUESTS + 2)]
    for batch in batches[:2]:
        step(params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[2:]:
            step(params, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / REQUESTS
    by_kernel = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    per_req = {k: v / 1e3 / REQUESTS for k, v in by_kernel.items()}
    device_ms = sum(per_req.values())
    print(f"{ARCH}, {REQUESTS} requests x {BATCH} images: "
          f"wall {wall_ms:.3f} ms/request, device {device_ms:.3f} "
          f"ms/request, busy share {device_ms / wall_ms:.3f}")
    for name, ms in sorted(per_req.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  {name[:90]}")
    print(json.dumps({"arch": ARCH, "batch": BATCH,
                      "wall_ms_per_request": wall_ms,
                      "device_ms_per_request": device_ms,
                      "busy_share": device_ms / wall_ms,
                      "kernels_ms_per_request": per_req,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
