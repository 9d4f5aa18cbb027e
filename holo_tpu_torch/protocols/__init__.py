"""The port's copies of ``holo_tpu``'s protocol layer.

``bgp_engine``: the BGP decision process the device BGP table decides over.
``ospf``: the OSPFv2 instance, from LSA install through the SPF-delay FSM
and route derivation to the RIB, with its SPF on the port's backends.  The
other protocols (OSPFv3, IS-IS, ...) are not ported yet.
"""
