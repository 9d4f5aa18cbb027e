"""The port's analysis layer: the runtime checks
(:mod:`holo_tpu_torch.analysis.runtime`: the transfer sanitizer and the
donation guard) and the kernel-contract audit (HL301-HL305), the
counterpart of ``holo_tpu.analysis``'s jaxpr audit:

- :mod:`holo_tpu_torch.analysis.kernels`: the registry every dispatch
  program registers in (inert: no thunk runs at registration);
- :mod:`holo_tpu_torch.analysis.kernel_audit`: runs each registered program
  once on seeded specs under a dispatch recorder and checks the contracts;
- :mod:`holo_tpu_torch.analysis.cache`: the per-kernel cache and
  ``self_check``;
- ``python -m holo_tpu_torch.analysis``: the entry point.

Nothing here imports torch at import time: a warm cached replay of the
audit runs on the standard library alone.  The AST lint of ``holo_tpu`` and
its cache arm are not ported (ROADMAP A13d).
"""
