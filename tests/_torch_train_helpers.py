"""One train step of the port held against the jitted JAX step, with the
tolerances of ``test_torch_train.py`` (each reason stated there):

* loss and fire rate bitwise (no spike flips);
* every gradient within 1e-4 of its leaf's scale;
* grad norm within 1e-6 relative;
* params after the step within 5e-5 absolute (AdamW's first step),
  plus, where a gradient lies near AdamW's eps, the first step's own
  amplification of the two gradients' difference (see
  :func:`adamw_bound`);
* the new BN running stats within 1e-5 of each leaf's scale;
* every param leaf moved.

The token family (``state=None``: no BN state, no fire rate) takes the
same tolerances but one: its loss within :data:`DENSE_LOSS_REL` relative
(the MoE family's with its router losses, as JAX's step adds them).
Its forward is no exact sum: rmsnorm's rsqrt and the analog projections
of its output round apart from XLA's (ROADMAP queue 3), so its logits
agree within 1e-5 (``test_torch_lm.py``), not bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import engine as JE
from repro.launch import steps as JS
from repro.models import registry as JR
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import interop
from repro_torch.launch import steps as TS
from repro_torch.optim import adamw, warmup_cosine

SCHED = (2e-3, 2, 10)
# a SMOKE arch of each token family past the dense one
FAMILY_ARCHS = {"moe": "deepseek-moe-16b", "rwkv": "rwkv6-3b",
                "hybrid": "hymba-1.5b", "encdec": "whisper-small",
                "vlm": "llava-next-mistral-7b"}
# the token family's loss: logits within 1e-5 of XLA's, through a
# log-softmax over the vocabulary that sums in another order (see above)
DENSE_LOSS_REL = 1e-6


def rel_close(got, want, rel, what=""):
    """|got - want| <= rel * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def adamw_bound(gj, gt, scale, lr0, eps=1e-8):
    """How far AdamW's first step (``p - lr0 * g / (|g| + eps)`` on the
    clipped gradient ``g * scale``, weight decay alike on both sides) can
    move a param apart given the two gradients: the derivative of ``g /
    (|g| + eps)`` is ``eps / (|g| + eps)^2``, largest at the smaller |g|
    between them (at 0 where their signs differ). It matters only for
    gradients within a few eps of 0, where it exceeds the 5e-5 of
    ``test_torch_train.py`` (a CIFAR-Net conv has such weights)."""
    gj, gt = gj * scale, gt * scale
    gmin = np.where(np.sign(gj) == np.sign(gt),
                    np.minimum(np.abs(gj), np.abs(gt)), 0.0)
    return lr0 * np.abs(gt - gj) * eps / (gmin + eps) ** 2


def check_train_step(cfg, tcfg, params, state, batch, qat=None):
    """JAX ``build_train_step(cfg, opt, qat=qat)`` under jit against the
    port's ``build_train_step(tcfg, opt, qat=qat)`` on the CPU, from the
    same numpy params, BN state (None for the token family) and batch.
    Returns the port's loss."""
    dense = state is None
    extra = () if dense else (state,)
    jopt, topt = jadamw(jwarmup_cosine(*SCHED)), adamw(warmup_cosine(*SCHED))
    jp, _, jstep, jm, *jst = jax.jit(JS.build_train_step(cfg, jopt, qat=qat))(
        params, jopt.init(params), jnp.asarray(0, jnp.int32), batch, *extra)

    def jloss(p):
        if qat is not None:
            from repro.quant import fake_quant_tree
            p = fake_quant_tree(p, qat)
        with JE.engine_scope(cfg):
            logits, aux = JR.forward(p, cfg, batch, train=True,
                                     **({} if dense else {"state": state}))
        loss = JS.loss_from_forward(cfg, logits, batch)
        # the MoE family's router losses, as JAX's train step adds them
        return loss + aux["moe_aux"] if "moe_aux" in aux else loss
    jgrads = jax.jit(jax.grad(jloss))(params)

    tp = interop.to_torch(params, device="cpu")
    ts = None if dense else interop.to_torch(state, device="cpu")
    step = TS.build_train_step(tcfg, topt, qat=qat, device="cpu")
    np_, _, nstep, tm, *nst = step(tp, topt.init(tp), 0, batch,
                                   *(() if dense else (ts,)))
    assert nstep == 1 and int(jstep) == 1

    def loss_eq(got, want):
        if dense:
            rel_close(got, want, DENSE_LOSS_REL, "loss")
        else:
            assert got == want
    loss_eq(float(tm["loss"]), float(jm["loss"]))
    if not dense:
        assert float(tm["fire_rate"]) == float(jm["fire_rate"])
    else:
        assert "fire_rate" not in tm
    rel_close(tm["grad_norm"].numpy(), jm["grad_norm"], 1e-6, "grad_norm")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _, tgrads = TS.value_and_grad(tcfg, tp, tb, ts, qat=qat)
    assert float(loss) == float(tm["loss"])
    loss_eq(float(loss), float(jm["loss"]))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    lr0 = float(warmup_cosine(*SCHED)(0))
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    bounds = iter([5e-5 + adamw_bound(np.asarray(j, np.float64),
                                      np.asarray(t, np.float64), clip, lr0)
                   for j, t in zip(jax.tree_util.tree_leaves(jgrads),
                                   jax.tree_util.tree_leaves(
                                       interop.to_numpy(tgrads)))])

    def param_close(g, w, n):
        err, bound = np.abs(g - w), next(bounds)
        assert (err <= bound).all(), \
            f"{n}: {err.max()} (bound there {bound.flat[err.argmax()]})"
    checks = [("grad", jgrads, tgrads, lambda g, w, n: rel_close(g, w, 1e-4,
                                                                 n)),
              ("param", jp, np_, param_close)]
    if not dense:
        checks.append(("state", jst[0], nst[0],
                       lambda g, w, n: rel_close(g, w, 1e-5, n)))
    for what, want, got, check in checks:
        jl = jax.tree_util.tree_leaves(want)
        tl = jax.tree_util.tree_leaves(interop.to_numpy(got))
        assert len(jl) == len(tl)
        names = paths if what != "state" else [""] * len(jl)
        for name, w, g in zip(names, jl, tl):
            assert np.shape(w) == np.shape(g)
            check(np.asarray(g, np.float64), np.asarray(w, np.float64),
                  what + name)
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(params),
        jax.tree_util.tree_leaves(interop.to_numpy(np_)))]
    assert all(moved)
    return float(loss)


def family_batch(cfg, batch: int, seq: int, step: int = 0):
    """``launch/train.make_batch_fn``'s batch of ``step`` (tokens, and the
    vlm / encdec families' stub embeddings) as CPU tensors."""
    from repro_torch.launch.train import make_batch_fn
    return {k: torch.from_numpy(v) for k, v in
            make_batch_fn(cfg, batch, seq)(step).items()}
