#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one CUDA
device; exits non-zero without one). It

1. builds every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc`` (``nvcc`` for sm_90a) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at
   the full width of Spikingformer-4-256 (T=4, B=64, L=64, D=256, H=8,
   hd=32, F=1024): bitwise in bf16 and fp32 on dyadic weights, and as
   information on random-normal weights; times both with CUDA events.
   It repeats the bitwise check with several L-blocks per sequence
   (``l_block < L``, one L-block of a sequence dark), which the main
   path does not reach;
3. drives the main path: the published Spikingformer-4-256 config, seeded
   random weights, ``build_prefill_step`` answering 4 requests of 64
   images, with every layer's launch of the fused kernel counted;
4. checks the output: finite logits of the right shape, and, on a small
   batch with dyadic weights, the fused path equal bitwise to the
   sequential oracle (``overlap='off'``).

It prints the card's name and power limit, a JSON line of per-kernel
numbers, and last a JSON line ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import use_engine  # noqa: E402
from repro_torch.core.spiking import SpikingConfig, lif_scan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_layer as FL  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores,
# HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# full width of Spikingformer-4-256 at a 64-image batch
T, B, L, D, H, HD, FF = 4, 64, 64, 256, 8, 32, 1024
FULL = (T, B, L, D, H, HD, FF)
# (what, (T, B, L, D, H, hd, F), l_block) with several L-blocks a sequence:
# the SMOKE width, the full width with a ragged last block, and an L that
# is not a multiple of the block
MULTI_BLOCK = [("SMOKE width", (2, 8, 16, 64, 4, 16, 128), 8),
               ("full width, ragged blocks", (4, 16, 64, 256, 8, 32, 1024), 24),
               ("SMOKE width, L=13", (2, 8, 13, 64, 4, 16, 128), 8)]
REQUESTS, REQUEST_BATCH = 4, 64


def log(msg):
    print(msg, flush=True)


def dyadic(gen, shape, bits=8):
    k = torch.randint(-(1 << bits), 1 << bits, shape, generator=gen)
    return k.float() * 2.0 ** -bits


def layer_operands(seed, dtype, dyadic_weights, shape=FULL, l_block=64):
    """Fused-layer operands (the layout layer_step builds): one dark
    (t=0, b=0) slab and, with several L-blocks, the first L-block of
    batch row 1 dark at every t."""
    T, B, L, D, H, HD, FF = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-64, 224, (T, B, L, D), generator=gen).float() / 128
    x[0, 0] = 0.0
    if l_block < L:
        x[:, 1, :l_block] = 0.0
    x = x.to(dtype)
    s = lif_scan(x, SpikingConfig(time_steps=T))[0]

    def weight(shape, fan_in):
        if dyadic_weights:
            return dyadic(gen, shape) * 0.25
        return torch.randn(shape, generator=gen) / math.sqrt(fan_in)

    def rows(n):
        return torch.stack([dyadic(gen, (n,)) * 0.5,
                            torch.rand((n,), generator=gen) + 0.5,
                            1.0 + dyadic(gen, (n,)) * 0.5,
                            dyadic(gen, (n,)) * 0.5])

    ops = (x, s, weight((3, D, H * HD), D), weight((H * HD, D), H * HD),
           weight((D, FF), D), weight((FF, D), FF),
           tuple(1.0 + dyadic(gen, shape, bits=4) * 0.5
                 for shape in ((3, H * HD), (D,), (FF,), (D,))),
           torch.stack([rows(H * HD) for _ in range(3)]), rows(D), rows(FF),
           rows(D), torch.tensor(0.3))
    ops = tree_map(lambda a: a.cuda(), ops)
    ops = ops[:2] + tuple(w.to(dtype) for w in ops[2:6]) + ops[6:]
    return FL.prepare(*ops, num_heads=H, head_dim=HD,
                      scale=1.0 / math.sqrt(HD), decay=0.5, v_th=1.0,
                      soft_reset=False, eps=1e-5, l_block=l_block)


def cuda_ms(fn, warmup=3, runs=20):
    """Median device time of ``fn`` in ms (CUDA events around each run)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def layer_bound_ms(args, counts, dtype, l_block=64):
    """Least time for the layer on the card: the executed sub-blocks'
    multiply-adds at the dtype's peak, or each input read once and each
    output written once at the memory rate, whichever is larger."""
    x = args[0]
    nlb = counts.shape[-1]
    rows = torch.tensor([min(L, (lb + 1) * l_block) - lb * l_block
                         for lb in range(nlb)], dtype=torch.float64)
    c = counts.double().cpu()
    ffc = FF // H
    macs_per_row = torch.tensor([D * HD] * 3 + [L * HD, L * HD, HD * D,
                                                D * ffc, ffc * D],
                                dtype=torch.float64)
    macs = float((c * rows[None, None, :]
                  * macs_per_row[None, :, None]).sum())
    ops_s = 2 * macs / PEAK_FLOPS[dtype]
    es = x.element_size()
    n_bytes = (3 * x.numel() * es
               + sum(w.numel() for w in args[2:6]) * es
               + sum(a.numel() * 4 for a in (*args[6], *args[7:12]))
               + counts.numel() * 4)
    bytes_s = n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def check_layer_kernel(dtype, what="full width", shape=FULL, l_block=64):
    """Kernel vs plain version on the card, dyadic weights: bitwise."""
    args, kw = layer_operands(1, dtype, True, shape, l_block)
    out_k, cnt_k = FL.fused_layer_cuda(*args, **kw)
    out_p, cnt_p = FL.fused_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    if not (torch.equal(out_k, out_p) and torch.equal(cnt_k, cnt_p)):
        raise AssertionError(f"fused_layer {dtype} {what}: kernel != plain "
                             f"version (max abs diff {err}, counts equal "
                             f"{torch.equal(cnt_k, cnt_p)})")
    log(f"fused_layer {dtype} {what}, l_block {kw['l_block']}, dyadic: "
        f"bitwise equal to the plain version; counts per phase and L-block "
        f"{cnt_k.sum(dim=0).t().tolist()}")
    return err


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, (sec, text) in _build.BUILD_LOG.items():
        lines = [ln for ln in text.splitlines() if "ptxas info" in ln]
        log(f"nvcc {name}.cu {sec:.1f} s\n  " + "\n  ".join(lines))

    # --- kernel against its plain version, full width ------------------
    max_err = max(check_layer_kernel(dt)
                  for dt in (torch.bfloat16, torch.float32))
    max_err = max([max_err] + [check_layer_kernel(dt, *case)
                               for case in MULTI_BLOCK
                               for dt in (torch.bfloat16, torch.float32)])
    for dt in (torch.bfloat16, torch.float32):
        args, kw = layer_operands(2, dt, dyadic_weights=False)
        out_k, _ = FL.fused_layer_cuda(*args, **kw)
        out_p, _ = FL.fused_layer_plain(*args, **kw)
        cfg_s = SpikingConfig(time_steps=T)
        agree = (lif_scan(out_k, cfg_s)[0] == lif_scan(out_p, cfg_s)[0]
                 ).float().mean()
        diff = float((out_k.float() - out_p.float()).abs().max())
        log(f"fused_layer {dt} random-normal weights (information only): "
            f"max abs diff {diff}, spike agreement of LIF(out) "
            f"{float(agree):.6f}")
    timing = {}
    for dt in (torch.bfloat16, torch.float32):
        args, kw = layer_operands(3, dt, dyadic_weights=False)
        ms = cuda_ms(lambda: FL.fused_layer_cuda(*args, **kw))
        plain_ms = cuda_ms(lambda: FL.fused_layer_plain(*args, **kw))
        _, counts = FL.fused_layer_cuda(*args, **kw)
        bound_ms, bound_by = layer_bound_ms(args, counts, dt)
        timing[dt] = (ms, plain_ms, bound_ms, bound_by)
        log(f"fused_layer {dt} full width: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")

    # --- the main path --------------------------------------------------
    cfg = get_config("spikingformer-4-256")
    params = registry.init(cfg, seed=0)
    step = build_prefill_step(cfg)
    gen = torch.Generator().manual_seed(1)
    v = cfg.vision
    requests = [{"images": torch.rand((REQUEST_BATCH, v.img_size, v.img_size,
                                       v.in_channels), generator=gen)}
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    FL.reset_launches()
    req_ms, outs = [], []
    for batch in requests:
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        req_ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(logits)
    launches = FL.LAUNCHES["fused_layer"]
    want = FL.LAUNCHES_PER_CALL * cfg.num_layers * REQUESTS
    log(f"main path: {REQUESTS} requests x {REQUEST_BATCH} images, "
        f"per-request ms {[round(m, 3) for m in req_ms]}, fused_layer "
        f"launches {launches}")
    if launches != want:
        raise AssertionError(f"fused_layer launched {launches} times, "
                             f"expected {want}")
    for logits in outs:
        if logits.shape != (REQUEST_BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits {tuple(logits.shape)}")

    # --- output check: fused == sequential oracle on a small batch ------
    dy = tree_map(lambda a: torch.round(a * 256) / 256
                  if a.is_floating_point() else a, params)
    for bn in [p["bn"] for p in dy["sps"]] + [
            v for k, v in dy["blocks"].items() if k.startswith("bn_")]:
        bn["bias"] = bn["bias"] + 0.25
    small = {"images": (torch.randint(0, 256, (8, v.img_size, v.img_size,
                                                v.in_channels),
                                       generator=gen) / 256.0).cuda()}
    res = {}
    for ov in ("off", "fused"):
        with use_engine(cfg.engine.replace(overlap=ov)), \
                torch.inference_mode():
            res[ov] = registry.forward(dy, cfg, small)
    if not torch.equal(res["off"][0], res["fused"][0]):
        raise AssertionError("fused logits differ from the sequential oracle")
    log(f"check: fused logits == oracle logits on 8 images (dyadic weights), "
        f"fire rate {float(res['fused'][1]['fire_rate']):.4f}, logit std "
        f"{float(res['fused'][0].std()):.4f}")

    ms, plain_ms, bound_ms, bound_by = timing[torch.bfloat16]
    log(json.dumps({"kernels": [{
        "name": "fused_layer", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_layer.cu",
        "replaces": "src/repro/kernels/fused_layer.py:420",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
