"""Where the time of the port's steps goes, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile [--sparse decoded]
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --quantize int8 --keep-fp wq,wk,wv
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch spikingformer-8-512 [--sparse decoded]
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch spikingformer-lm [--quantize int8 [--keep-fp wo,up,down]]
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch spikingformer-8-512 --overlap pipeline
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch spikingformer-8-512 --analog
    PYTHONPATH=src python -m repro_torch.launch.profile --arch cifarnet
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch h2o-danube-3-4b      # or gemma3-12b, nemotron-4-15b, ...
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch deepseek-moe-16b     # or kimi-k2-1t-a32b (2 layers)
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch rwkv6-3b   # or hymba-1.5b, whisper-small, llava-next-...

Spikingformer-4-256 (the default): the published config (seeded random
weights; ``--sparse`` sets its sparse datapath, 'auto' by default) on
batches of 64 images through ``build_prefill_step`` and through
``build_train_step`` (AdamW, warmup-cosine); with ``--quantize`` only
the prefill, on the int8 (or int4) tree of weights that fire (BN biases
raised by 1/4, as ``chip_smoke.py`` does: on the random weights every
layer input is dark and the sparse kernels skip everything), with the
linears named by ``--keep-fp`` left unquantized (``--keep-fp
wq,wk,wv``: the mixed-precision tree, whose layers run ``fused_ssa``
and the int8 sparse products). Spikingformer-8-512 (the paper's ImageNet
workload, 224x224 images): the published config's prefill only, on
weights that fire (BN biases raised by 1/4), in batches of 64 images;
its training step is not profiled. The
published spikingformer-lm (``--quantize int8``: its int8 tree, as
``launch/serve.py --quantize int8`` loads it; with ``--keep-fp
wo,up,down`` the mixed tree of int8 wq, wk, wv and the LM head, whose
layers run the bundle kernel's rope family) through
``build_prefill_step`` on 8 x 512 tokens, without ``--quantize``
through ``build_train_step`` (AdamW, warmup-cosine) on 8 x 512 tokens of
the synthetic token stream, and through the continuous-batching server:
one call serves 8 requests of 100-500 prompt tokens and 8 new tokens
each over 8 slots. ``--overlap fused|pipeline``
sets the layer program's schedule (default the config's, 'auto', which
fuses on the card); with it the prefill alone is profiled (a vision
model's on weights that fire, BN biases raised), and the run prints the
layer program's launches per call and, for 'pipeline', the membrane
bytes it moves beyond the fused schedule. CIFAR-Net (``--arch
cifarnet``, the published config: T=4, 32x32 images, seeded random
weights) has no engine and takes none of the engine's options: its
prefill and train step, 64 images a call, are plain PyTorch (cuDNN's
convolutions and PyTorch's elementwise kernels). The dense decoders
(``--arch h2o-danube-3-4b``, ``gemma3-12b``, ``nemotron-4-15b``,
``granite-20b``; published configs, bf16, seeded random weights, no
engine) run no kernel of the port: their prefill (8 x 512 tokens through
``build_prefill_step``) and a server call (8 requests of 100-500 prompt
tokens, 8 new tokens each, over 8 slots, in prefill bites of
DENSE_CHUNK: the chunk policy's bites of 4-16 tokens would take a wave
through every layer for each) are plain PyTorch. The MoE decoders
(``--arch deepseek-moe-16b`` at published width and depth,
``kimi-k2-1t-a32b`` at published width cut to MOE_LAYERS of its 61
layers, one dense and one MoE, which is what one card holds; bf16,
seeded random weights, no engine) run no kernel of the port either:
their prefill (MOE_PREFILL = 4 x 512 tokens through
``build_prefill_step``) and a decode loop (``build_serve_step``: a call
feeds MOE_DECODE steps of 4 rows from an empty cache) are plain PyTorch,
the expert products ``torch.bmm`` in bf16 (the MoE family has no
continuous-batching server, as in JAX). rwkv6-3b, hymba-1.5b,
whisper-small and llava-next-mistral-7b (published configs, bf16,
seeded random weights, no engine) run no kernel of the port either:
a prefill through ``build_prefill_step`` and a decode loop through
``build_serve_step`` from a fresh cache, at OTHER_SHAPES' rows, prompt
tokens and steps (whisper's prompt follows its 1500 stub frames, whose
cross K / V ``init_cache`` computes inside each decode call; llava's its
2880 stub patches, and its decode continues text). ``--analog`` takes
the config with analog attention scores (its spiking config with
``binarize_scores=False``, Spikformer's own SSA), whose layers run the
sequential composition with the SSA bundle's analog kernel; the prefill
alone is profiled (a vision model's on weights that fire; the LM's
server is left out, since its decode binarizes the scores whatever the
config says, as JAX's does). Each step gets two warm-up
calls, then three under ``torch.profiler``. For each it prints the wall
time per call, the device time per call and the launches summed by
kernel name, and the device's busy share (kernel time over wall time),
then one JSON line with the same numbers. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import (DENSE_ARCHS, MOE_ARCHS, OTHER_ARCHS,
                                 get_config)
from repro_torch.kernels import fused_layer as FL
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step)
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import registry
from repro_torch.optim import adamw, warmup_cosine

BATCH = 64
CALLS = 3
TOP = 12
LM_BATCH, LM_PROMPT = 8, 512
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW, SERVE_MAX_LEN = 8, 8, 8, 1024
DENSE_CHUNK = 256
MOE_PREFILL = (4, 512)
MOE_DECODE = 32
MOE_LAYERS = {"kimi-k2-1t-a32b": 2}
# (rows, prompt tokens, decode steps) of the rwkv, hybrid, encdec and vlm
# archs
OTHER_SHAPES = {"rwkv6-3b": (4, 1024, 32), "hymba-1.5b": (2, 512, 32),
                "whisper-small": (2, 64, 64),
                "llava-next-mistral-7b": (1, 128, 16)}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile(arch: str, what: str, sparse: str, call,
             unit: str = f"{BATCH} images") -> None:
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
    by_kernel, calls = {}, {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
            calls[evt.key] = calls.get(evt.key, 0) + evt.count
    per_call = {k: v / 1e3 / CALLS for k, v in by_kernel.items()}
    launches = {k: n / CALLS for k, n in calls.items()}
    device_ms = sum(per_call.values())
    print(f"{arch} {what}, sparse={sparse!r}, {CALLS} calls x {unit}: "
          f"wall {wall_ms:.3f} ms/call, device {device_ms:.3f} ms/call, "
          f"busy share {device_ms / wall_ms:.3f}")
    for name, ms in sorted(per_call.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:9.4f} ms  {100 * ms / device_ms:5.1f}%  "
              f"{launches[name]:6.1f}x  {name[:90]}")
    print(json.dumps({"arch": arch, "step": what, "unit": unit,
                      "sparse": sparse,
                      "wall_ms_per_call": wall_ms,
                      "device_ms_per_call": device_ms,
                      "busy_share": device_ms / wall_ms,
                      "kernels_ms_per_call": per_call,
                      "kernel_launches_per_call": launches,
                      "device": torch.cuda.get_device_name(0)}))


def _layer_program_traffic(call) -> None:
    """Prints the layer program's launches in one ``call()`` and the
    membrane bytes its pipelined launches move beyond the fused schedule,
    from the shapes they are handed."""
    moved = [0]
    real = FL.fused_layer_pipeline_cuda

    def spy(x, s, w3, wo, w1, *args, **kw):
        t, b, l, d = x.shape
        moved[0] += FL.membrane_bytes(x.element_size(), t, b, l, d,
                                      w3.shape[-1], w1.shape[1],
                                      kw.get("family") == "rope")
        return real(x, s, w3, wo, w1, *args, **kw)
    FL.reset_launches()
    FL.fused_layer_pipeline_cuda = spy
    try:
        call()
        torch.cuda.synchronize()
    finally:
        FL.fused_layer_pipeline_cuda = real
    print(f"layer program per call: launches "
          f"{ {k: n for k, n in FL.LAUNCHES.items() if n} }, membrane bytes "
          f"beyond the fused schedule {moved[0]}")


def _quantized(params, quantize: str, keep_fp):
    """``params`` with its linears quantized, except those named in
    ``keep_fp``."""
    from repro_torch.quant import quantize_tree
    return quantize_tree(params, quantize, select=lambda path: path.rsplit(
        "/", 1)[-1] not in keep_fp)


def _profile_lm(cfg, quantize: str, keep_fp, overlap=None,
                prefill_only=False) -> None:
    params = registry.init(cfg, seed=0)
    if quantize != "none":
        params = _quantized(params, quantize, keep_fp)
        if not keep_fp:
            cfg = cfg.replace(engine=cfg.engine.replace(weights=quantize))
    what = quantize if quantize != "none" else cfg.dtype
    if keep_fp:
        what += f", fp {','.join(keep_fp)}"
    if not cfg.spiking.binarize_scores:
        what += ", analog scores"
    arch = f"{cfg.name} ({what})"
    prefill = build_prefill_step(cfg)
    gen = torch.Generator().manual_seed(1)
    tokens = [torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen).cuda() for _ in range(CALLS + 2)]
    _profile(arch, "prefill", cfg.engine.sparse,
             lambda i: prefill(params, {"tokens": tokens[i]}),
             unit=f"{LM_BATCH} x {LM_PROMPT} tokens")
    if overlap is not None:
        _layer_program_traffic(lambda: prefill(params, {"tokens": tokens[0]}))
    if overlap is not None or prefill_only:
        return
    if quantize == "none":
        opt = adamw(warmup_cosine(2e-3, 1, CALLS + 2))
        train_step = build_train_step(cfg, opt)
        batch_fn = make_batch_fn(cfg, LM_BATCH, LM_PROMPT)
        batches = [batch_fn(i) for i in range(CALLS + 2)]
        carry = [params, opt.init(params)]

        def train(i):
            carry[:2] = train_step(*carry, i, batches[i])[:2]
        _profile(arch, "train", cfg.engine.sparse, train,
                 unit=f"{LM_BATCH} x {LM_PROMPT} tokens")

    _profile(arch, "serve", cfg.engine.sparse, _serve_call(cfg, params),
             unit=f"{SERVE_REQUESTS} requests x {SERVE_NEW} new tokens")


def _serve_call(cfg, params, chunk: int = 0):
    """``call(i)``: one server run of SERVE_REQUESTS requests of 100-500
    prompt tokens (seed i), SERVE_NEW new tokens each, prefill bites of
    ``chunk`` (0: the chunk policy's)."""
    from repro_torch.launch.serve import BatchedServer, Request

    def serve(i):
        rng = np.random.default_rng(i)
        server = BatchedServer(cfg, params, SERVE_SLOTS, SERVE_MAX_LEN,
                               chunk=chunk)
        for r in range(SERVE_REQUESTS):
            n = int(rng.integers(100, 501))
            server.submit(Request(rid=r, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=SERVE_NEW))
        server.run()
    return serve


def _profile_dense(cfg) -> None:
    """A dense decoder's prefill and server (no engine, no kernel)."""
    params = registry.init(cfg, seed=0)
    arch = f"{cfg.name} ({cfg.dtype})"
    prefill = build_prefill_step(cfg)
    gen = torch.Generator().manual_seed(1)
    tokens = [torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen).cuda() for _ in range(CALLS + 2)]
    _profile(arch, "prefill", None,
             lambda i: prefill(params, {"tokens": tokens[i]}),
             unit=f"{LM_BATCH} x {LM_PROMPT} tokens")
    _profile(arch, f"serve (bites of {DENSE_CHUNK})", None,
             _serve_call(cfg, params, DENSE_CHUNK),
             unit=f"{SERVE_REQUESTS} requests x {SERVE_NEW} new tokens")


def _profile_moe(cfg) -> None:
    """An MoE decoder's prefill and decode loop (no engine, no kernel)."""
    layers = MOE_LAYERS.get(cfg.name, cfg.num_layers)
    cfg = cfg.replace(num_layers=layers)
    params = registry.init(cfg, seed=0)
    arch = f"{cfg.name} ({cfg.dtype}, {layers} layers)"
    prefill = build_prefill_step(cfg)
    gen = torch.Generator().manual_seed(1)
    tokens = [torch.randint(0, cfg.vocab_size, MOE_PREFILL,
                            generator=gen).cuda() for _ in range(CALLS + 2)]
    _profile(arch, "prefill", None,
             lambda i: prefill(params, {"tokens": tokens[i]}),
             unit=f"{MOE_PREFILL[0]} x {MOE_PREFILL[1]} tokens")
    serve = build_serve_step(cfg)
    rows = MOE_PREFILL[0]

    def decode(i):
        cache = registry.init_cache(cfg, rows, MOE_DECODE)
        for pos in range(MOE_DECODE):
            _, cache = serve(params, cache, tokens[i][:, pos:pos + 1], pos)
    _profile(arch, "decode loop", None, decode,
             unit=f"{rows} rows x {MOE_DECODE} steps")


def _profile_other(cfg) -> None:
    """rwkv6-3b, hymba-1.5b, whisper-small or llava-next-mistral-7b: a
    prefill and a decode loop (no engine, no kernel)."""
    rows, prompt, n_steps = OTHER_SHAPES[cfg.name]
    params = registry.init(cfg, seed=0)
    arch = f"{cfg.name} ({cfg.dtype})"
    batch_fn = make_batch_fn(cfg, rows, prompt)
    batches = []
    for i in range(CALLS + 2):
        b = {k: torch.from_numpy(v).cuda() for k, v in batch_fn(i).items()}
        for key in ("patch_embeds", "audio_embeds"):
            if key in b:
                b[key] = b[key].to(getattr(torch, cfg.dtype))
        batches.append(b)
    unit = f"{rows} x {prompt} tokens"
    if cfg.family == "vlm":
        unit += f" + {cfg.frontend.num_embeds} patches"
    elif cfg.family == "encdec":
        unit += f" + {cfg.encoder_seq} frames"
    prefill = build_prefill_step(cfg)
    _profile(arch, "prefill", None, lambda i: prefill(params, batches[i]),
             unit=unit)
    serve = build_serve_step(cfg)

    def decode(i):
        cross = batches[i] if cfg.family == "encdec" else None
        cache = registry.init_cache(cfg, rows, n_steps, batch=cross,
                                    params=params)
        for pos in range(n_steps):
            _, cache = serve(params, cache,
                             batches[i]["tokens"][:, pos:pos + 1], pos)
    _profile(arch, "decode loop", None, decode,
             unit=f"{rows} rows x {n_steps} steps")


def _firing_vision(cfg):
    """The vision params of seed 0 with every BN bias raised by 1/4, so
    layer inputs fire."""
    params = registry.init(cfg, seed=0)
    for k, v in params["blocks"].items():
        if k.startswith("bn_"):
            v["bias"] = v["bias"] + 0.25
    for p in params["sps"]:
        p["bn"]["bias"] = p["bn"]["bias"] + 0.25
    return params


def _quantized_vision(cfg, quantize: str, keep_fp):
    """(cfg, params): the vision tree of weights that fire, its linears
    quantized except those named in ``keep_fp``; a fully quantized tree
    declares its weights datapath, a mixed one stays 'fp32'."""
    params = _quantized(_firing_vision(cfg), quantize, keep_fp)
    if not keep_fp:
        cfg = cfg.replace(engine=cfg.engine.replace(weights=quantize))
    return cfg, params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="spikingformer-4-256",
                    choices=["spikingformer-4-256", "spikingformer-8-512",
                             "spikingformer-lm", "cifarnet", *DENSE_ARCHS,
                             *MOE_ARCHS, *OTHER_ARCHS])
    ap.add_argument("--sparse", default=None,
                    choices=["tile", "decoded", "auto"],
                    help="the engine's sparse datapath (default: the "
                         "config's)")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "int4"],
                    help="quantize the linears at load")
    ap.add_argument("--keep-fp", default="",
                    help="comma-separated linear names left unquantized "
                         "under --quantize")
    ap.add_argument("--overlap", default=None, choices=["fused", "pipeline"],
                    help="the layer program's schedule (default: the "
                         "config's); profiles the prefill alone")
    ap.add_argument("--analog", action="store_true",
                    help="analog attention scores (binarize_scores=False); "
                         "profiles the prefill alone")
    args = ap.parse_args()
    keep_fp = tuple(n for n in args.keep_fp.split(",") if n)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products (the MoE experts) sum in fp32, as the reference's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    cfg = get_config(args.arch)
    if cfg.engine is None and (args.sparse or args.overlap or args.analog
                               or keep_fp or args.quantize != "none"):
        raise SystemExit(f"profile: {args.arch} has no engine and takes "
                         f"none of --sparse, --overlap, --analog, "
                         f"--quantize, --keep-fp")
    if args.sparse is not None:
        cfg = cfg.replace(engine=cfg.engine.replace(sparse=args.sparse))
    if args.overlap is not None:
        cfg = cfg.replace(engine=cfg.engine.replace(overlap=args.overlap))
    if args.analog:
        cfg = cfg.replace(spiking=dataclasses.replace(
            cfg.spiking, binarize_scores=False))
    if args.arch in DENSE_ARCHS:
        _profile_dense(cfg)
        return
    if args.arch in MOE_ARCHS:
        _profile_moe(cfg)
        return
    if args.arch in OTHER_ARCHS:
        _profile_other(cfg)
        return
    if args.arch == "spikingformer-lm":
        _profile_lm(cfg, args.quantize, keep_fp, args.overlap, args.analog)
        return
    eight = args.arch == "spikingformer-8-512"
    firing = eight or args.overlap is not None or args.analog
    if args.quantize != "none":
        cfg, params = _quantized_vision(cfg, args.quantize, keep_fp)
    elif firing:
        params = _firing_vision(cfg)
    else:
        params = registry.init(cfg, seed=0)
    prefill = build_prefill_step(cfg)
    gen = torch.Generator().manual_seed(1)
    v = cfg.vision
    images = [torch.rand((BATCH, v.img_size, v.img_size, v.in_channels),
                         generator=gen).cuda() for _ in range(CALLS + 2)]
    what = "prefill" if args.quantize == "none" else \
        f"prefill ({args.quantize}, fp {','.join(keep_fp) or 'none'})"
    if firing:
        what += ", BN biases raised"
    if args.overlap is not None:
        what += f", overlap={args.overlap!r}"
    if args.analog:
        what += ", analog scores"
    sparse = cfg.engine.sparse if cfg.engine is not None else None
    _profile(args.arch, what, sparse,
             lambda i: prefill(params, {"images": images[i]}))
    if args.overlap is not None:
        _layer_program_traffic(lambda: prefill(params, {"images": images[0]}))
    if args.quantize != "none" or firing:
        # an int8 tree takes no train step (QAT trains the fp masters);
        # the layer program's schedule, the analog scores and 8-512 are
        # profiled on the prefill
        return

    opt = adamw(warmup_cosine(2e-3, 1, CALLS + 2))
    train_step = build_train_step(cfg, opt)
    batch_fn = make_batch_fn(cfg, BATCH)
    batches = [batch_fn(i) for i in range(CALLS + 2)]
    carry = [params, opt.init(params), registry.init_state(cfg)]

    def train(i):
        p, o, _, _, st = train_step(carry[0], carry[1], i, batches[i],
                                    carry[2])
        carry[:] = [p, o, st]
    _profile(args.arch, "train", sparse, train)


if __name__ == "__main__":
    main()
