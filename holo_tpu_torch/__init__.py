"""PyTorch/CUDA port of holo_tpu for NVIDIA Hopper.

The module layout mirrors ``holo_tpu`` so each module's counterpart is easy
to find.  The port imports ``torch`` and never ``jax``, and nothing of
``holo_tpu``: host-side helpers it needs are kept as its own copies.

``spf.backend.TorchSpfBackend`` runs SPF on two engines, as ``holo_tpu``'s
backend does: the default gather engine (``ops/spf_engine.py``, the ELL
fixpoints, kernels in ``csrc/ell_kernels.cu``) and the blocked engine
(``ops/blocked_spf.py``, kernels in ``csrc/blocked_kernels.cu``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no device given and no GPU present they raise
(:func:`holo_tpu_torch.device.resolve_device`).
"""
