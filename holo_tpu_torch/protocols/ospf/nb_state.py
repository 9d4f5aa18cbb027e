"""The interface and neighbor state names of the ietf-ospf YANG model (the
port's copy of the two name tables of ``holo_tpu.protocols.ospf.nb_state``;
the instance's notifications and transition counters read them).  The
northbound state rendering itself is not ported."""

from __future__ import annotations

from holo_tpu_torch.protocols.ospf.interface import IsmState
from holo_tpu_torch.protocols.ospf.neighbor import NsmState

_ISM_NAME = {
    IsmState.DOWN: "down",
    IsmState.LOOPBACK: "loopback",
    IsmState.WAITING: "waiting",
    IsmState.POINT_TO_POINT: "point-to-point",
    IsmState.DR_OTHER: "dr-other",
    IsmState.BACKUP: "bdr",
    IsmState.DR: "dr",
}

_NSM_NAME = {
    NsmState.DOWN: "down",
    NsmState.ATTEMPT: "attempt",
    NsmState.INIT: "init",
    NsmState.TWO_WAY: "2-way",
    NsmState.EX_START: "exstart",
    NsmState.EXCHANGE: "exchange",
    NsmState.LOADING: "loading",
    NsmState.FULL: "full",
}
