"""PyTorch/CUDA port of holo_tpu for NVIDIA Hopper.

The module layout mirrors ``holo_tpu`` so each module's counterpart is easy
to find.  The port imports ``torch`` and never ``jax``, and nothing of
``holo_tpu``: host-side helpers it needs are kept as its own copies.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no device given and no GPU present they raise
(:func:`holo_tpu_torch.device.resolve_device`).
"""
