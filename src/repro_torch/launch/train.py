"""Fault-tolerant training loop, as ``repro.launch.train``.

Runs ``build_train_step`` on deterministic synthetic data (images for
the vision family, a Markov token stream for the token family: the
dense and MoE decoders, rwkv6-3b, hymba-1.5b and spikingformer-lm, with
stub frame embeddings for whisper-small and stub patch embeddings for
llava-next-mistral-7b, as JAX's) with AdamW under a warmup-cosine
schedule, on the GPU unless ``--device`` names another device, with:

* ``--qat int8|int4``: quantization-aware training (the loss sees
  fake-quantized linears, the fp masters take the straight-through
  gradients);
* ``--compress-grads``: int8 gradient compression with error feedback
  (the token family; the vision step does not read it, as in JAX);
* ``--ckpt-dir`` / ``--ckpt-every``: async checkpoints in the JAX
  package's format, and a restore of the latest one when a segment
  starts;
* ``--inject-failure-at``: a simulated failure at that step, from which
  the supervisor restarts: the latest checkpoint is restored and the
  data stream replayed from its step;
* a straggler monitor that flags steps slower than twice the running
  mean.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-4-256 --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-lm --smoke --steps 30 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-4-256 --steps 6 --batch 64      # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-4-256 --steps 6 --batch 64 --sparse decoded
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch spikingformer-lm --steps 30 --batch 8 --seq 512 --qat int8 \\
      --ckpt-dir build/lm_ck --ckpt-every 10 --inject-failure-at 15
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch cifarnet --steps 6 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch h2o-danube-3-4b --smoke --steps 10 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-moe-16b --smoke --steps 10 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-small --smoke --steps 10 --seq 32 --device cpu \\
      --qat int8       # or rwkv6-3b, hymba-1.5b, llava-next-mistral-7b

The MoE family logs its router losses (``moe_aux``, part of the loss)
beside the loss.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import STATEFUL, build_train_step
from repro_torch.models import registry
from repro_torch.optim import adamw, compress_state_init, warmup_cosine
from repro_torch.runtime import (FailureInjector, StragglerMonitor,
                                 TrainSupervisor)
from repro_torch.tree import tree_leaves


def make_batch_fn(cfg, batch_size: int, seq_len: int = 128) -> Callable:
    """step -> numpy batch: {'images', 'labels'} of the vision family,
    {'tokens'} (batch_size, seq_len) of the token family, with the vlm
    family's 'patch_embeds' (batch_size, num_embeds, embed_dim) and the
    encdec family's 'audio_embeds' (batch_size, encoder_seq, d_model):
    fp32 normal draws of std 0.02 from a generator seeded with the step,
    as JAX's."""
    if cfg.family in STATEFUL:
        return make_pipeline(DataConfig(
            kind="images", global_batch=batch_size,
            img_size=cfg.vision.img_size, channels=cfg.vision.in_channels,
            num_classes=cfg.vocab_size)).batch_at
    lm_batch = make_pipeline(DataConfig(
        kind="lm", global_batch=batch_size, seq_len=seq_len,
        vocab_size=cfg.vocab_size)).batch_at
    if cfg.family == "vlm":
        key, shape = "patch_embeds", (cfg.frontend.num_embeds,
                                      cfg.frontend.embed_dim)
    elif cfg.family == "encdec":
        key, shape = "audio_embeds", (cfg.encoder_seq, cfg.d_model)
    else:
        return lm_batch

    def batch_at(step):
        b = lm_batch(step)
        b[key] = np.random.default_rng(step).normal(
            0, 0.02, (batch_size, *shape)).astype(np.float32)
        return b
    return batch_at


def train(arch: str, smoke: bool, total_steps: int, batch: int, lr: float,
          seed: int = 0, device: DeviceLike = None,
          sparse: Optional[str] = None, qat: Optional[str] = None, *,
          seq: int = 128, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, inject_failure_at: Optional[int] = None,
          compress: bool = False, log_every: int = 10) -> List[float]:
    """Train ``arch`` from random weights (``seed``) for ``total_steps``
    steps under the supervisor; returns the loss of every step run,
    replayed steps included. ``sparse`` overrides the engine's sparse
    datapath (tile | decoded | auto); ``qat`` ('int8' | 'int4') trains
    quantization-aware; ``compress`` compresses the token family's
    gradients. With ``ckpt_dir`` a checkpoint of params and optimizer
    state (and the BN state of the vision family) is saved every
    ``ckpt_every`` steps and, blocking, at the end; a segment starts from
    the latest one there. ``inject_failure_at`` fails that step once."""
    cfg = get_config(arch, smoke=smoke)
    if sparse is not None:
        if cfg.engine is None:
            raise ValueError(f"{arch} has no engine: --sparse does not "
                             f"apply")
        cfg = cfg.replace(engine=cfg.engine.replace(sparse=sparse))
    stateful = cfg.family in STATEFUL
    dev = resolve_device(device)
    opt = adamw(warmup_cosine(lr, max(1, total_steps // 20), total_steps))
    batch_fn = make_batch_fn(cfg, batch, seq)
    step_fn = build_train_step(cfg, opt, compress=compress, qat=qat,
                               device=dev)
    params = registry.init(cfg, seed, device=dev)
    opt_state = opt.init(params)
    if compress:
        opt_state["compress_err"] = compress_state_init(params)
    model_state = registry.init_state(cfg, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name} ({'smoke' if smoke else 'full'}) on {dev}: "
          f"{n_params / 1e6:.2f}M params, {total_steps} steps, "
          f"batch={batch}{'' if stateful else f' seq={seq}'}"
          f"{f', qat={qat}' if qat else ''}"
          f"{', compressed grads' if compress else ''}", flush=True)

    cm = CheckpointManager(ckpt_dir) if ckpt_dir else None
    injector = FailureInjector(failure_steps=[inject_failure_at]
                               if inject_failure_at else [])
    monitor = StragglerMonitor(
        on_straggler=lambda r: print(
            f"[straggler] step {r.step}: {r.seconds * 1e3:.0f} ms",
            flush=True))
    supervisor = TrainSupervisor(max_restarts=3)
    losses: List[float] = []

    def state_tree():
        tree = {"params": params, "opt": opt_state}
        if stateful:
            tree["model_state"] = model_state
        return tree

    def run_segment(start_step: int) -> int:
        nonlocal params, opt_state, model_state
        if cm is not None:
            # a save still in flight when the failure struck lands first,
            # so the restore reads the latest checkpoint
            cm.wait()
        if cm is not None and cm.latest_step() is not None:
            tree, start_step, _ = cm.restore(state_tree(), device=dev)
            params, opt_state = tree["params"], tree["opt"]
            if stateful:
                model_state = tree["model_state"]
            print(f"[train] restored checkpoint @ step {start_step}",
                  flush=True)
        step = start_step
        while step < total_steps:
            injector.maybe_fail(step)
            b = batch_fn(step)
            t0 = time.time()
            if stateful:
                params, opt_state, _, metrics, model_state = step_fn(
                    params, opt_state, step, b, model_state)
            else:
                params, opt_state, _, metrics = step_fn(params, opt_state,
                                                        step, b)
            loss = float(metrics["loss"])       # waits for the step
            monitor.observe(step, time.time() - t0)
            losses.append(loss)
            if step % log_every == 0 or step == total_steps - 1:
                extra = f" fire={float(metrics['fire_rate']):.3f}" \
                    if "fire_rate" in metrics else ""
                if "moe_aux" in metrics:
                    extra += f" moe_aux={float(metrics['moe_aux']):.4f}"
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}{extra}",
                      flush=True)
            step += 1
            if cm is not None and step % ckpt_every == 0:
                cm.save(step, state_tree())
        if cm is not None:
            cm.save(total_steps, state_tree(), blocking=True)
        return step

    final = supervisor.run(run_segment, 0, total_steps)
    if supervisor.restarts:
        print(f"[train] survived {len(supervisor.restarts)} restart(s): "
              f"{supervisor.restarts}", flush=True)
    if monitor.straggler_steps:
        print(f"[train] straggler steps flagged: {monitor.straggler_steps}",
              flush=True)
    print(f"[train] done @ step {final}; first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}", flush=True)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ALL_ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="tokens a sequence (the token family)")
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    args = ap.parse_args()
    train(args.arch, args.smoke, args.steps, args.batch, args.lr, args.seed,
          args.device, args.sparse, args.qat, seq=args.seq,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          inject_failure_at=args.inject_failure_at,
          compress=args.compress_grads)


if __name__ == "__main__":
    main()
