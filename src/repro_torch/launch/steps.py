"""Step builders: the training step, the inference step and the two
decode steps of the serving path.

As in ``repro.launch.steps``, every builder wraps its forward in
``engine_scope(cfg)``, so one config knob (``ModelConfig.engine``) drives
the dual-engine dispatch of the whole forward. Steps run on the GPU
unless the caller names another device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunShape
from repro_torch.core.engine import engine_scope
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import registry
from repro_torch.optim import Optimizer, compressed_gradients
from repro_torch.quant import INT_BITS, fake_quant_tree
from repro_torch.tree import tree_leaves, tree_unflatten

STATEFUL = ("spikingformer", "cifarnet")


# ---------------------------------------------------------------------------
# abstract inputs: meta tensors, shaped as JAX's ShapeDtypeStructs (no
# allocation), for the spec tables of parallel/rules.py
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: RunShape) -> Dict[str, Any]:
    """Abstract batch for forward / train at this run shape."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        n_patch = cfg.frontend.num_embeds
        return {"tokens": _meta((b, s - n_patch), torch.int32),
                "patch_embeds": _meta((b, n_patch, cfg.frontend.embed_dim),
                                      dt)}
    if cfg.family == "encdec":
        return {"tokens": _meta((b, s), torch.int32),
                "audio_embeds": _meta((b, cfg.encoder_seq, cfg.d_model), dt)}
    if cfg.family in STATEFUL:
        v = cfg.vision
        return {"images": _meta((b, v.img_size, v.img_size, v.in_channels),
                                dt),
                "labels": _meta((b,), torch.int32)}
    return {"tokens": _meta((b, s), torch.int32)}


def cache_struct(cfg: ModelConfig, shape: RunShape):
    """Abstract decode cache (``init_cache`` on the meta device)."""
    return registry.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta")


def decode_inputs_struct(cfg: ModelConfig, shape: RunShape):
    return (cache_struct(cfg, shape),
            _meta((shape.global_batch, 1), torch.int32),
            _meta((), torch.int32))


def abstract_params(cfg: ModelConfig, seed: int = 0):
    """The params tree on the meta device: shapes and dtypes, no
    storage."""
    return registry.init(cfg, seed, device="meta")


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return nll.mean()


def loss_from_forward(cfg: ModelConfig, logits, batch) -> torch.Tensor:
    """Cross entropy of the labels (vision) or of each next token (the
    token family: the logits at positions 0..S-2 against tokens 1..S-1;
    the vlm family's text tokens against the logits from the last patch
    on, so no patch position is a target)."""
    if cfg.family in STATEFUL:
        return softmax_xent(logits, batch["labels"])
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        n_patch = cfg.frontend.num_embeds
        return softmax_xent(logits[:, n_patch - 1:-1], tokens)
    return softmax_xent(logits[:, :-1], tokens[:, 1:])


def value_and_grad(cfg: ModelConfig, params, batch, model_state=None, *,
                   qat: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
    """Train-mode loss and its gradient with respect to every param leaf:
    (loss, aux, grads) with grads in the params' tree layout and dtypes.
    ``model_state`` is the BN running-stats tree of the stateful (vision)
    family, None for the token family. The MoE family's router losses
    (``aux['moe_aux']``, detached there) are part of the loss, as in JAX.
    ``qat`` ('int8' | 'int4'): the forward sees the linears
    fake-quantized (``quant.fake_quant_tree``, applied to the leaves being
    differentiated; the MoE expert stacks and router, bare arrays, stay
    fp, as in JAX), and the straight-through gradients reach the fp
    masters."""
    fq = (lambda p: p) if qat is None else \
        (lambda p: fake_quant_tree(p, qat))
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    state = {"state": model_state} if cfg.family in STATEFUL else {}
    # the stem's convolutions run in full fp32, as the reference does, in
    # the backward too: nn.conv2d turns cuDNN's TF32 default off for its
    # forward call only, and autograd runs the backward after it returns
    cudnn = torch.backends.cudnn
    no_tf32 = cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                          deterministic=cudnn.deterministic,
                          allow_tf32=False)
    with engine_scope(cfg), torch.enable_grad(), no_tf32:
        logits, aux = registry.forward(fq(tree_unflatten(params, leaves)),
                                       cfg, batch, train=True, **state)
        loss = loss_from_forward(cfg, logits, batch)
        if "moe_aux" in aux:
            loss = loss + aux["moe_aux"]
            aux = dict(aux, moe_aux=aux["moe_aux"].detach())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), aux, tree_unflatten(params, grads)


def build_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                     compress: bool = False, qat: Optional[str] = None,
                     device: DeviceLike = None) -> Callable:
    """The training step on ``device`` (the GPU by default), as JAX's:

    * the stateful vision family: (params, opt_state, step, batch,
      model_state) -> (params, opt_state, step + 1, metrics, model_state),
      ``model_state`` the BN running-stats tree, metrics loss, grad_norm
      and fire_rate;
    * the token family: (params, opt_state, step, batch) -> (params,
      opt_state, step + 1, metrics), metrics loss and grad_norm (and the
      MoE family's ``moe_aux``, which the loss includes).

    Metrics are 0-d tensors. ``qat`` ('int8' | 'int4') trains
    quantization-aware: see :func:`value_and_grad`; the optimizer updates
    the fp masters. ``compress`` sends the token family's gradients
    through the int8 round trip with error feedback
    (``optim.compressed_gradients``), the residuals carried in
    ``opt_state["compress_err"]`` (``optim.compress_state_init``); the
    vision step does not read it, as JAX's does not."""
    if qat is not None and qat not in INT_BITS:
        raise ValueError(f"unknown qat dtype {qat!r} (expected one of "
                         f"{sorted(INT_BITS)})")
    dev = resolve_device(device)

    def to_dev(batch):
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    if cfg.family in STATEFUL:
        def train_step(params, opt_state, step, batch, model_state):
            loss, aux, grads = value_and_grad(cfg, params, to_dev(batch),
                                              model_state, qat=qat)
            new_params, new_opt = optimizer.update(grads, opt_state, params,
                                                   step)
            metrics = {"loss": loss, "grad_norm": new_opt["grad_norm"],
                       "fire_rate": aux["fire_rate"]}
            return new_params, new_opt, step + 1, metrics, aux["state"]
        return train_step

    def train_step(params, opt_state, step, batch):
        loss, aux, grads = value_and_grad(cfg, params, to_dev(batch),
                                          qat=qat)
        if compress:
            grads, new_err = compressed_gradients(grads,
                                                  opt_state["compress_err"])
        new_params, new_opt = optimizer.update(grads, opt_state, params,
                                               step)
        if compress:
            new_opt["compress_err"] = new_err
        metrics = {"loss": loss, "grad_norm": new_opt["grad_norm"]}
        if "moe_aux" in aux:
            metrics["moe_aux"] = aux["moe_aux"]
        return new_params, new_opt, step + 1, metrics
    return train_step


def build_prefill_step(cfg: ModelConfig, *,
                       device: DeviceLike = None) -> Callable:
    """Inference forward over the full sequence: (params, batch) ->
    logits, on ``device`` (the GPU by default); batch holds 'images'
    (vision) or 'tokens' (B, S) (token family). Like the JAX step it
    passes no BN state, so a vision forward runs on ``init_state`` (mean
    0, var 1)."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        with engine_scope(cfg), torch.inference_mode():
            logits, _ = registry.forward(params, cfg, batch, train=False)
        return logits
    return prefill_step


def build_serve_step(cfg: ModelConfig, *,
                     device: DeviceLike = None) -> Callable:
    """One decode step: (params, cache, tokens (B, 1), pos) ->
    (next-token logits, cache), on ``device`` (the GPU by default)."""
    dev = resolve_device(device)

    def serve_step(params, cache, tokens, pos):
        with engine_scope(cfg), torch.inference_mode():
            return registry.decode_step(params, cfg, cache,
                                        torch.as_tensor(tokens).to(dev), pos)
    return serve_step


def build_batched_serve_step(cfg: ModelConfig, *,
                             device: DeviceLike = None) -> Callable:
    """The continuous-batching step (slotted-decode families): (params,
    cache, tokens (B, C), pos (B,), n_tok (B,)) -> (logits (B, C, V),
    cache). Every slot runs its own timeline; a row's tokens beyond
    n_tok are padding."""
    dev = resolve_device(device)

    def serve_step(params, cache, tokens, pos, n_tok):
        with engine_scope(cfg), torch.inference_mode():
            return registry.decode_step(
                params, cfg, cache, torch.as_tensor(tokens).to(dev),
                torch.as_tensor(pos).to(dev), n_tok=torch.as_tensor(
                    n_tok).to(dev))
    return serve_step
