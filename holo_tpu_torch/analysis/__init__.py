"""The port's runtime checks (:mod:`holo_tpu_torch.analysis.runtime`)."""
