"""Spikingformer and CIFAR-Net — the paper's evaluated vision workloads
(§V-A).

Mirrors ``repro.models.spikingformer``. Spikingformer: SPS conv stem ->
encoder blocks (each the engine's layer program) -> rate-decoded
classification head, with pre-neuron residuals. CIFAR-Net (FireFly v2's
spiking conv network): direct coding over T, then for each conv of
:data:`CIFARNET_SPEC` the conv, BN, LIF and its pool, and a linear head
on the fp32 spike rate; it is plain PyTorch (convs through cuDNN with
TF32 off, ``core.spiking.lif_scan``) and launches no kernel, as JAX's
reaches no Pallas kernel. Params and BN state keep the JAX tree layout
(HWIO conv weights, per-layer block leaves stacked on a leading axis;
CIFAR-Net's ``{"convs": [{"conv", "bn"}, ...], "head"}``).
``forward(train=True)`` normalises with batch statistics and threads the
BN running stats through. ``layer_sparsities`` measures the per-layer
spike sparsity (the paper's Fig. 11).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import layer_step
from repro_torch.core.spiking import lif_scan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map
from . import nn


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _sps_channels(cfg: ModelConfig) -> List[int]:
    d = cfg.d_model
    return [max(8, d // 8), max(8, d // 4), max(16, d // 2), d]


def _sps_pools(cfg: ModelConfig) -> List[bool]:
    n = 4
    stages = cfg.vision.sps_stages
    return [i >= n - stages for i in range(n)]


def _stack(*leaves):
    return torch.stack(leaves)


# CIFAR-Net conv spec: (channels, pool) per layer; pool in {'', 'mp', 'ap'}
CIFARNET_SPEC: Tuple[Tuple[int, str], ...] = (
    (32, ""), (256, ""), (256, "mp"), (256, ""), (256, ""), (256, "mp"),
    (512, "mp"), (1024, "ap"))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    d = cfg.d_model
    return {
        "wq": nn.linear_init(gen, d, cfg.q_dim, dtype=dt),
        "wk": nn.linear_init(gen, d, cfg.q_dim, dtype=dt),
        "wv": nn.linear_init(gen, d, cfg.q_dim, dtype=dt),
        "wo": nn.linear_init(gen, cfg.q_dim, d, dtype=dt),
        "bn_q": nn.batchnorm_init(cfg.q_dim, dt),
        "bn_k": nn.batchnorm_init(cfg.q_dim, dt),
        "bn_v": nn.batchnorm_init(cfg.q_dim, dt),
        "bn_o": nn.batchnorm_init(d, dt),
        "delta": torch.tensor(cfg.spiking.attn_threshold_init,
                              dtype=torch.float32),
        "w1": nn.linear_init(gen, d, cfg.d_ff, dtype=dt),
        "bn_1": nn.batchnorm_init(cfg.d_ff, dt),
        "w2": nn.linear_init(gen, cfg.d_ff, d, dtype=dt),
        "bn_2": nn.batchnorm_init(d, dt),
    }


def _block_state(cfg: ModelConfig):
    return {"bn_q": nn.batchnorm_state_init(cfg.q_dim),
            "bn_k": nn.batchnorm_state_init(cfg.q_dim),
            "bn_v": nn.batchnorm_state_init(cfg.q_dim),
            "bn_o": nn.batchnorm_state_init(cfg.d_model),
            "bn_1": nn.batchnorm_state_init(cfg.d_ff),
            "bn_2": nn.batchnorm_state_init(cfg.d_model)}


def init(cfg: ModelConfig, seed: int = 0, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """Random params from ``seed`` (drawn on the CPU, then moved to the
    device, so a seed gives the same weights on every machine)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "cifarnet":
        return tree_map(lambda a: a.to(dev), _init_cifarnet(cfg, gen))
    dt = dtype_of(cfg)
    chans = [cfg.vision.in_channels] + _sps_channels(cfg)
    sps = [{"conv": nn.conv2d_init(gen, chans[i], chans[i + 1], dtype=dt),
            "bn": nn.batchnorm_init(chans[i + 1], dt)} for i in range(4)]
    blocks = [_block_init(gen, cfg) for _ in range(cfg.num_layers)]
    params = {
        "sps": sps,
        "blocks": tree_map(_stack, *blocks),
        "head": nn.linear_init(gen, cfg.d_model, cfg.vocab_size, bias=True,
                               dtype=dt),
    }
    return tree_map(lambda a: a.to(dev), params)


def init_state(cfg: ModelConfig, *, device: DeviceLike = None
               ) -> Dict[str, Any]:
    dev = resolve_device(device)
    if cfg.family == "cifarnet":
        state = {"convs": [nn.batchnorm_state_init(c)
                           for c, _ in CIFARNET_SPEC]}
        return tree_map(lambda a: a.to(dev), state)
    state = {"sps": [nn.batchnorm_state_init(c) for c in _sps_channels(cfg)],
             "blocks": tree_map(_stack, *[_block_state(cfg)
                                          for _ in range(cfg.num_layers)])}
    return tree_map(lambda a: a.to(dev), state)


def _init_cifarnet(cfg: ModelConfig, gen: torch.Generator):
    dt = dtype_of(cfg)
    convs = []
    c_in = cfg.vision.in_channels
    for c, _ in CIFARNET_SPEC:
        convs.append({"conv": nn.conv2d_init(gen, c_in, c, dtype=dt),
                      "bn": nn.batchnorm_init(c, dt)})
        c_in = c
    return {"convs": convs,
            "head": nn.linear_init(gen, c_in, cfg.vocab_size, bias=True,
                                   dtype=dt)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _lif(x, cfg: ModelConfig):
    return lif_scan(x, cfg.spiking)[0]


def _fold_t(f, x, *args, **kw):
    """Apply f over (T*B, ...) by folding the time axis."""
    t = x.shape[0]
    y = f(x.reshape(-1, *x.shape[2:]), *args, **kw)
    return y.reshape(t, -1, *y.shape[1:])


def _sps(params, state, cfg: ModelConfig, images, train: bool):
    """images: (B, H, W, C) -> (tokens (T, B, L, D), new sps state)."""
    t = cfg.spiking.time_steps
    x = images[None].expand(t, *images.shape)            # direct coding
    pools = _sps_pools(cfg)
    new_state = []
    for i, p in enumerate(params["sps"]):
        x = _fold_t(lambda u: nn.conv2d(p["conv"], u), x)
        x, st = nn.batchnorm(p["bn"], state["sps"][i], x, train=train)
        new_state.append(st)
        if i < len(params["sps"]) - 1:
            x = _lif(x, cfg)                 # spikes feed the next conv
        if pools[i]:
            x = _fold_t(nn.maxpool2, x)
    tt, b, h, w, d = x.shape
    return x.reshape(tt, b, h * w, d), new_state


def _block(p, st, cfg: ModelConfig, x, train: bool):
    """One encoder layer, owned by the engine (core.engine.layer_step)."""
    return layer_step(p, st, cfg, x, train=train)


def forward(params, cfg: ModelConfig, batch, *, train: bool = False,
            state: Optional[Dict] = None):
    """batch: {'images': (B, H, W, C)} -> (logits (B, classes), aux) with
    aux {'state': new BN running stats, 'fire_rate'}.

    Images are taken in the config's dtype, as ``launch/steps.
    batch_struct`` declares them in the JAX package."""
    images = batch["images"].to(dtype_of(cfg))
    if state is None:
        state = init_state(cfg, device=images.device)
    if cfg.family == "cifarnet":
        return _forward_cifarnet(params, cfg, images, train=train,
                                 state=state)
    x, sps_state = _sps(params, state, cfg, images, train)
    blocks_state = []
    for i in range(cfg.num_layers):
        bp = tree_map(lambda a: a[i], params["blocks"])
        bst = tree_map(lambda a: a[i], state["blocks"])
        x, new_bst = _block(bp, bst, cfg, x, train)
        blocks_state.append(new_bst)
    spikes = _lif(x, cfg)
    rate = spikes.float().mean(dim=(0, 2))                # (B, D)
    logits = nn.linear(params["head"], rate.to(x.dtype)).float()
    new_state = {"sps": sps_state, "blocks": tree_map(_stack, *blocks_state)}
    return logits, {"state": new_state,
                    "fire_rate": spikes.detach().float().mean()}


def _conv_bn_lif(p, st, cfg: ModelConfig, x, train: bool):
    """One CIFAR-Net conv stage before its pool: conv over the folded
    (T*B) images, BN over every leading axis, LIF over T. Returns
    (spikes, new BN state)."""
    x = _fold_t(lambda u: nn.conv2d(p["conv"], u), x)
    y, new_st = nn.batchnorm(p["bn"], st, x, train=train)
    return _lif(y, cfg), new_st


def _pool(x, pool: str):
    if pool == "mp":
        return _fold_t(nn.maxpool2, x)
    if pool == "ap":
        return x.mean(dim=(2, 3))                       # (T, B, C)
    return x


def _forward_cifarnet(params, cfg: ModelConfig, images, *, train: bool,
                      state: Dict):
    """Direct coding (the image repeated over T), the conv ladder, and
    the head on the fp32 spike rate averaged over T."""
    x = images[None].expand(cfg.spiking.time_steps, *images.shape)
    new_state = []
    for (_, pool), p, st in zip(CIFARNET_SPEC, params["convs"],
                                state["convs"]):
        x, st = _conv_bn_lif(p, st, cfg, x, train)
        new_state.append(st)
        x = _pool(x, pool)
    rate = x.float().mean(dim=0)                        # (B, C)
    logits = nn.linear(params["head"], rate.to(dtype_of(cfg))).float()
    return logits, {"state": {"convs": new_state},
                    "fire_rate": x.detach().float().mean()}


def layer_sparsities(params, cfg: ModelConfig, batch,
                     state: Optional[Dict] = None) -> List[Tuple[str, float]]:
    """Per-layer spike sparsity (Fig. 11): [(layer name, 1 - fire rate)]
    for the stem's output spikes and each encoder layer's input spikes
    (CIFAR-Net: each conv's output spikes, before its pool), measured on
    ``batch`` in eval mode — what the decoded datapath's gain and
    ``sparse='auto'``'s choice depend on."""
    images = batch["images"].to(dtype_of(cfg))
    if state is None:
        state = init_state(cfg, device=images.device)
    out: List[Tuple[str, float]] = []
    if cfg.family == "cifarnet":
        x = images[None].expand(cfg.spiking.time_steps, *images.shape)
        with torch.no_grad():
            for i, ((_, pool), p, st) in enumerate(zip(
                    CIFARNET_SPEC, params["convs"], state["convs"])):
                x, _ = _conv_bn_lif(p, st, cfg, x, train=False)
                out.append((f"conv{i}", float(1.0 - x.mean())))
                x = _pool(x, pool)
        return out
    with torch.no_grad():
        x, _ = _sps(params, state, cfg, images, train=False)
        out.append(("sps", float(1.0 - _lif(x, cfg).mean())))
        for i in range(cfg.num_layers):
            bp = tree_map(lambda a: a[i], params["blocks"])
            bst = tree_map(lambda a: a[i], state["blocks"])
            out.append((f"block{i}.in", float(1.0 - _lif(x, cfg).mean())))
            x, _ = _block(bp, bst, cfg, x, train=False)
    return out
