"""gRPC Northbound service (hand-registered handlers over generated
protobuf messages — no grpc codegen plugin needed); the port's copy of
``holo_tpu.daemon.grpc_server``, wire-compatible with it (the service is
``holo_tpu.Northbound`` on both).

Reference surface: the 10-RPC service of holo's proto/holo.proto
(Capabilities, GetSchema, GetConfig, GetState, Validate, Commit, Execute,
ListTransactions, GetTransaction, Subscribe), re-specified in
proto/holo_tpu.proto with JSON-encoded data trees.  ``holo_tpu_pb2`` is
the generated module of that file (the same serialized descriptor as
``holo_tpu``'s, so both load into one process), imported by its package
path.  Needs the ``grpc`` package; the daemon imports this module only
when ``[grpc]`` is enabled.
"""

from __future__ import annotations

import json
import queue
import time
from concurrent import futures
from pathlib import Path

import grpc

import holo_tpu_torch
from holo_tpu_torch.daemon import holo_tpu_pb2 as pb
from holo_tpu_torch.northbound.provider import CommitError
from holo_tpu_torch.yang.data import DataTree
from holo_tpu_torch.yang.schema import SchemaError


class NorthboundService:
    """Service implementation bound to a Daemon."""

    def __init__(self, daemon):
        self.daemon = daemon
        self._subscribers: list[queue.Queue] = []

    # -- RPC implementations (each takes request, context)

    def Capabilities(self, request, context):
        return pb.CapabilitiesResponse(
            version=holo_tpu_torch.__version__,
            modules=sorted(self.daemon.northbound.schema.roots.keys()),
        )

    def GetSchema(self, request, context):
        def describe(node):
            from holo_tpu_torch.yang.schema import Container, Leaf, LeafList, List

            if isinstance(node, Leaf):
                return {"kind": "leaf", "type": node.type, "default": str(node.default)}
            if isinstance(node, LeafList):
                return {"kind": "leaf-list", "type": node.type}
            if isinstance(node, List):
                return {
                    "kind": "list",
                    "key": node.key,
                    "children": {n: describe(c) for n, c in node.children.items()},
                }
            return {
                "kind": "container",
                "children": {n: describe(c) for n, c in node.children.items()},
            }

        roots = self.daemon.northbound.schema.roots
        if request.module:
            node = roots.get(request.module)
            out = {request.module: describe(node)} if node else {}
        else:
            out = {n: describe(c) for n, c in roots.items()}
        return pb.GetSchemaResponse(schema_json=json.dumps(out))

    @staticmethod
    def _encode_payload(obj, encoding, root_tag: str) -> str:
        """YANG-XML / LYB-lite (base64) per the request's DataEncoding
        (reference client grpc.rs:43-454).  ``obj`` must already be a
        JSON-plain tree (scalars stringified, keyed maps expanded)."""
        if not isinstance(obj, dict):
            obj = {"value": obj}
        if encoding == pb.XML:
            from holo_tpu_torch.yang.serde import to_xml

            return to_xml(obj, root_tag)
        import base64

        from holo_tpu_torch.yang.serde import to_lyb

        return base64.b64encode(to_lyb(obj)).decode()

    def GetConfig(self, request, context):
        with self.daemon.lock:
            tree = self.daemon.northbound.running
            if request.encoding == pb.JSON:
                if request.path:
                    payload = json.dumps(tree.get(request.path), default=str)
                else:
                    payload = tree.to_json()
            else:
                from holo_tpu_torch.yang.serde import config_to_plain

                schema = self.daemon.northbound.schema
                if request.path:
                    obj = tree.get(request.path)
                    try:
                        node = schema.resolve(request.path)
                    except Exception:  # noqa: BLE001 — leaf paths etc.
                        node = None
                    obj = config_to_plain(node, obj)
                else:
                    obj = {
                        name: config_to_plain(
                            schema.roots.get(name), val
                        )
                        for name, val in tree.root.items()
                    }
                obj = json.loads(json.dumps(obj, default=str))
                payload = self._encode_payload(
                    obj, request.encoding, "config"
                )
        return pb.GetConfigResponse(config_json=payload)

    def GetState(self, request, context):
        with self.daemon.lock:
            state = self.daemon.northbound.get_state(request.path or None)
        if request.encoding == pb.JSON:
            payload = json.dumps(state, default=str)
        else:
            # State trees are already plain (dicts = containers, JSON
            # lists = list entries) — no keyed maps to expand.
            state = json.loads(json.dumps(state, default=str))
            payload = self._encode_payload(state, request.encoding, "state")
        return pb.GetStateResponse(state_json=payload)

    def Validate(self, request, context):
        try:
            cand = DataTree.from_json(
                self.daemon.northbound.schema, request.config_json
            )
            with self.daemon.lock:
                for p in self.daemon.northbound.providers:
                    p.validate(cand)
            return pb.ValidateResponse(error="")
        except (SchemaError, CommitError) as e:
            return pb.ValidateResponse(error=str(e))

    def Commit(self, request, context):
        nb = self.daemon.northbound
        try:
            if request.operation == pb.CommitOperation.CHANGE or request.edits:
                cand = nb.running.copy()
                for edit in request.edits:
                    if edit.operation == "delete":
                        cand.delete(edit.path)
                    else:
                        value = edit.value if edit.value != "" else None
                        # Leaf-lists cross the wire as JSON arrays (a
                        # PathEdit value is a string); scalars that
                        # merely look like JSON stay strings unless the
                        # parse yields a list.
                        if isinstance(value, str) and value.lstrip().startswith("["):
                            try:
                                parsed = json.loads(value)
                                if isinstance(parsed, list):
                                    value = parsed
                            except ValueError:
                                pass
                        cand.set(edit.path, value)
            elif request.operation == pb.CommitOperation.REPLACE:
                cand = DataTree.from_json(nb.schema, request.config_json)
            else:  # MERGE
                cand = nb.running.copy()
                merged = DataTree.from_json(nb.schema, request.config_json)
                _merge_tree(cand.root, merged.root)
            txn = self.daemon.commit(
                cand,
                comment=request.comment,
                confirmed_timeout=request.confirmed_timeout or None,
            )
            return pb.CommitResponse(transaction_id=txn.id, error="")
        except (SchemaError, CommitError) as e:
            return pb.CommitResponse(transaction_id=0, error=str(e))

    def Execute(self, request, context):
        try:
            input_ = json.loads(request.input_json) if request.input_json else {}
            with self.daemon.lock:
                if request.rpc_name == "confirm-commit":
                    self.daemon.northbound.confirm()
                    return pb.ExecuteResponse(output_json="{}")
                for p in self.daemon.northbound.providers:
                    try:
                        out = p.rpc(request.rpc_name, input_)
                        return pb.ExecuteResponse(
                            output_json=json.dumps(out, default=str)
                        )
                    except KeyError:
                        continue
            return pb.ExecuteResponse(output_json=json.dumps({"error": "unknown rpc"}))
        except Exception as e:  # surface provider errors to the client
            return pb.ExecuteResponse(output_json=json.dumps({"error": str(e)}))

    def ListTransactions(self, request, context):
        return pb.ListTransactionsResponse(
            transactions=[
                pb.TransactionInfo(id=t.id, timestamp=t.timestamp, comment=t.comment)
                for t in self.daemon.northbound.txn_log
            ]
        )

    def GetTransaction(self, request, context):
        try:
            t = self.daemon.northbound.get_transaction(request.id)
        except KeyError:
            context.abort(grpc.StatusCode.NOT_FOUND, f"no transaction {request.id}")
        return pb.GetTransactionResponse(
            info=pb.TransactionInfo(id=t.id, timestamp=t.timestamp, comment=t.comment),
            changes_json=t.changes_json,
            config_json=t.config_json,
        )

    def Subscribe(self, request, context):
        q: queue.Queue = queue.Queue(maxsize=256)
        self._subscribers.append(q)
        topics = set(request.topics)
        try:
            while context.is_active():
                try:
                    topic, payload = q.get(timeout=1.0)
                except queue.Empty:
                    continue
                if topics and topic not in topics:
                    continue
                yield pb.Notification(
                    topic=topic,
                    payload_json=json.dumps(payload, default=str),
                    timestamp=time.time(),
                )
        finally:
            self._subscribers.remove(q)

    def _notify(self, topic: str, payload) -> None:
        for q in list(self._subscribers):
            try:
                q.put_nowait((topic, payload))
            except queue.Full:
                pass


def _merge_tree(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_tree(dst[k], v)
        else:
            dst[k] = v


_UNARY = [
    "Capabilities",
    "GetSchema",
    "GetConfig",
    "GetState",
    "Validate",
    "Commit",
    "Execute",
    "ListTransactions",
    "GetTransaction",
]


def _handlers(service: NorthboundService) -> grpc.GenericRpcHandler:
    method_handlers = {}
    svc = pb.DESCRIPTOR.services_by_name["Northbound"]
    for m in svc.methods:
        req_cls = getattr(pb, m.input_type.name)
        resp_cls = getattr(pb, m.output_type.name)
        fn = getattr(service, m.name)
        if m.name in _UNARY:
            method_handlers[m.name] = grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
        else:  # Subscribe: unary -> stream
            method_handlers[m.name] = grpc.unary_stream_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
    return grpc.method_handlers_generic_handler("holo_tpu.Northbound", method_handlers)


def _bind(server, address: str, tls_cert=None, tls_key=None) -> None:
    """Bind the listen port, with TLS when both PEM paths are set
    (holo-daemon grpc.rs TLS option).  A half-configured TLS pair is a
    hard error — never silently fail open to plaintext."""
    if bool(tls_cert) != bool(tls_key):
        raise ValueError(
            "TLS misconfigured: need both tls-cert and tls-key"
        )
    if tls_cert and tls_key:
        creds = grpc.ssl_server_credentials(
            [(Path(tls_key).read_bytes(), Path(tls_cert).read_bytes())]
        )
        server._bound_port = server.add_secure_port(address, creds)
    else:
        server._bound_port = server.add_insecure_port(address)


def serve(daemon, address: str, tls_cert=None, tls_key=None) -> grpc.Server:
    service = NorthboundService(daemon)
    daemon.add_commit_listener(
        lambda txn: service._notify(
            "commit", {"transaction-id": txn.id, "comment": txn.comment}
        )
    )
    # Protocol YANG notifications stream on their own topic (the
    # notification's qualified name), so Subscribe(topics=[...]) can
    # filter e.g. just "ietf-ospf:nbr-state-change".
    daemon.add_notification_listener(
        lambda payload: [
            service._notify(kind, body) for kind, body in payload.items()
        ]
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers((_handlers(service),))
    _bind(server, address, tls_cert, tls_key)
    server.start()
    daemon._grpc_service = service
    return server


class NorthboundClient:
    """Minimal client for tests/CLI (generic channel callables)."""

    def __init__(self, address: str):
        self.channel = grpc.insecure_channel(address)
        svc = pb.DESCRIPTOR.services_by_name["Northbound"]
        self._calls = {}
        for m in svc.methods:
            req_cls = getattr(pb, m.input_type.name)
            resp_cls = getattr(pb, m.output_type.name)
            path = f"/holo_tpu.Northbound/{m.name}"
            if m.name in _UNARY:
                self._calls[m.name] = self.channel.unary_unary(
                    path,
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString,
                )
            else:
                self._calls[m.name] = self.channel.unary_stream(
                    path,
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString,
                )

    def __getattr__(self, name):
        try:
            return self._calls[name]
        except KeyError as e:
            raise AttributeError(name) from e
