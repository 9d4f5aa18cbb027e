"""The port's gRPC northbound (``holo_tpu_torch.daemon.grpc_server``)
against ``holo_tpu``'s, over gRPC on localhost.

One daemon of each package (virtual clock; the port's on the CPU), each
serving its own gRPC server; every request goes to both, through both
packages' clients (the service is ``holo_tpu.Northbound`` on both wires):
``Capabilities``, ``GetSchema``, ``Commit`` (edits, then a replace and a
merge), ``Validate``, ``GetConfig`` and ``GetState`` in JSON, XML and LYB,
``ListTransactions``, ``GetTransaction`` and ``Execute``.  The responses are
equal except for ``Capabilities``' version string (each package's own) and
the wall-clock timestamps of the transactions.  Skipped only where the
``grpc`` package is missing.

Tolerance: exact (the response messages).
"""

from __future__ import annotations

import json
from ipaddress import IPv4Address

import pytest

pytest.importorskip("grpc")

from holo_tpu.daemon import daemon as jdaemon  # noqa: E402
from holo_tpu.daemon import grpc_server as jgrpc  # noqa: E402
from holo_tpu.utils.runtime import VirtualClock as JVirtualClock  # noqa: E402
from holo_tpu_torch.daemon import daemon as tdaemon  # noqa: E402
from holo_tpu_torch.daemon import grpc_server as tgrpc  # noqa: E402
from holo_tpu_torch.daemon import holo_tpu_pb2 as pb  # noqa: E402
from holo_tpu_torch.utils.runtime import VirtualClock as TVirtualClock  # noqa: E402

OSPF = "routing/control-plane-protocols/ospfv2"
EDITS = [
    ("interfaces/interface[eth0]/address", '["10.9.0.1/24"]'),
    ("interfaces/interface[eth1]/address", '["10.8.0.1/30"]'),
    ("system/hostname", "r1"),
    (f"{OSPF}/router-id", "1.1.1.1"),
    (f"{OSPF}/spf-control/backend", "scalar"),
    (f"{OSPF}/area[0.0.0.0]/interface[eth0]/passive", "true"),
    (f"{OSPF}/area[0.0.0.0]/interface[eth1]/cost", "7"),
]
ENCODINGS = {"json": pb.JSON, "xml": pb.XML, "lyb": pb.LYB}


@pytest.fixture(scope="module")
def served():
    """{package: (daemon, [port's client, holo_tpu's client])}, configured
    by the same Commit of EDITS."""
    daemons = {"port": tdaemon.Daemon(clock=TVirtualClock(), device="cpu"),
               "jax": jdaemon.Daemon(clock=JVirtualClock())}
    out = {}
    for name, d in daemons.items():
        server = d.start_grpc("127.0.0.1:0")
        address = f"127.0.0.1:{server._bound_port}"
        out[name] = (d, [tgrpc.NorthboundClient(address), jgrpc.NorthboundClient(address)])
    yield out
    for d, clients in out.values():
        for c in clients:
            c.channel.close()
        d.stop()


def _both(served, rpc: str, request) -> dict:
    """{package: [response through each client]}."""
    return {name: [getattr(c, rpc)(request, timeout=30) for c in clients]
            for name, (_, clients) in served.items()}


@pytest.fixture(scope="module")
def committed(served):
    change = pb.CommitRequest(operation=pb.CommitOperation.CHANGE, comment="edits",
                              edits=[pb.PathEdit(path=p, value=v) for p, v in EDITS])
    first = {name: clients[0].Commit(change, timeout=30)
             for name, (_, clients) in served.items()}
    return {name: (r.transaction_id, r.error) for name, r in first.items()}


def test_capabilities_equal_but_the_version(served):
    got = _both(served, "Capabilities", pb.CapabilitiesRequest())
    port, jax = got["port"], got["jax"]
    assert all(r.version == "0.1.0+torch" for r in port)
    assert all(r.version == "0.1.0" for r in jax)
    assert [list(r.modules) for r in port] == [list(r.modules) for r in jax]
    assert "routing" in port[0].modules


@pytest.mark.parametrize("module", ["", "routing", "interfaces"])
def test_get_schema_is_equal(served, module):
    got = _both(served, "GetSchema", pb.GetSchemaRequest(module=module))
    texts = [r.schema_json for rs in got.values() for r in rs]
    assert len(set(texts)) == 1 and json.loads(texts[0])


def test_commit_edits_replace_and_merge_are_equal(served, committed):
    assert committed["port"] == committed["jax"] == (1, "")
    running = {name: d.northbound.running.to_json() for name, (d, _) in served.items()}
    assert running["port"] == running["jax"]
    assert {n: d.routing.instances["ospfv2"].config.router_id
            for n, (d, _) in served.items()} == dict.fromkeys(served, IPv4Address("1.1.1.1"))
    # Replace with the running tree itself (no change), then merge a cost.
    replace = pb.CommitRequest(operation=pb.CommitOperation.REPLACE, config_json=running["port"])
    merged = json.loads(running["port"])
    merged["routing"]["control-plane-protocols"]["ospfv2"]["area"]["0.0.0.0"]["interface"][
        "eth1"]["cost"] = 9
    merge = pb.CommitRequest(operation=pb.CommitOperation.MERGE, config_json=json.dumps(merged))
    for req in (replace, merge):
        got = {name: clients[0].Commit(req, timeout=30) for name, (_, clients) in served.items()}
        assert (got["port"].transaction_id, got["port"].error) == (
            got["jax"].transaction_id, got["jax"].error)
    assert {name: d.northbound.running.get(f"{OSPF}/area[0.0.0.0]/interface[eth1]/cost")
            for name, (d, _) in served.items()} == {"port": 9, "jax": 9}


def test_validate_is_equal(served, committed):
    bad = json.loads(served["port"][0].northbound.running.to_json())
    bad["routing"]["control-plane-protocols"]["ospfv2"]["area"]["0.0.0.0"]["interface"][
        "eth0"]["authentication"] = {"key-chain": "missing"}
    for cfg, want in ((bad, "interface eth0: unknown key-chain 'missing'"),
                      (json.loads(served["port"][0].northbound.running.to_json()), "")):
        got = _both(served, "Validate", pb.ValidateRequest(config_json=json.dumps(cfg)))
        assert {r.error for rs in got.values() for r in rs} == {want}


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
@pytest.mark.parametrize("path", ["", "interfaces", f"{OSPF}/area"])
def test_get_config_is_equal(served, committed, encoding, path):
    got = _both(served, "GetConfig", pb.GetConfigRequest(path=path,
                                                          encoding=ENCODINGS[encoding]))
    texts = {r.config_json for rs in got.values() for r in rs}
    assert len(texts) == 1 and len(texts.pop()) > 10


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_get_state_is_equal(served, committed, encoding):
    got = _both(served, "GetState", pb.GetStateRequest(path="routing",
                                                        encoding=ENCODINGS[encoding]))
    texts = {r.state_json for rs in got.values() for r in rs}
    assert len(texts) == 1
    if encoding == "json":
        state = json.loads(texts.pop())
        assert state["routing"]["ospfv2"]["router-id"] == "1.1.1.1"
        assert state["interfaces"]["interface"]["eth0"]["oper-status"] == "up"


def test_transactions_and_execute_are_equal(served, committed):
    listed = _both(served, "ListTransactions", pb.ListTransactionsRequest())
    rows = {name: [[(t.id, t.comment) for t in r.transactions] for r in rs]
            for name, rs in listed.items()}
    assert rows["port"] == rows["jax"] and rows["port"][0][0] == (1, "edits")
    got = _both(served, "GetTransaction", pb.GetTransactionRequest(id=1))
    bodies = {(r.info.id, r.info.comment, r.changes_json, r.config_json)
              for rs in got.values() for r in rs}
    assert len(bodies) == 1
    done = _both(served, "Execute", pb.ExecuteRequest(rpc_name="confirm-commit"))
    unknown = _both(served, "Execute", pb.ExecuteRequest(rpc_name="no-such-rpc"))
    assert {r.output_json for rs in done.values() for r in rs} == {"{}"}
    assert {r.output_json for rs in unknown.values() for r in rs} == {'{"error": "unknown rpc"}'}
