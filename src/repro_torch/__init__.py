"""PyTorch + CUDA port of the FireFly-T reproduction (``src/repro``).

The JAX package stays the reference; this package mirrors its module
names so each counterpart is easy to find. It imports ``torch`` and
nothing of ``jax`` or ``repro``. Entry points run on the GPU unless the
caller passes ``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
