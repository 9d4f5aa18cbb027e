"""The port's copies of the protocol-layer surfaces its device backends read.

``holo_tpu``'s protocols import no JAX and are not ported; a device backend
of the port still needs the cells and the oracle it decides over, so it keeps
its own copy here (``bgp_engine``: the BGP decision process).
"""
