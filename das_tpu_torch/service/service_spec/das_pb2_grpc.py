"""gRPC stubs for das.proto, written by hand against the stable grpc API
(a copy of `das_tpu/service/service_spec/das_pb2_grpc.py`): method paths
`/das.ServiceDefinition/<rpc>`, protobuf request messages, `Status`
responses.
"""

import grpc

try:
    from . import das_pb2
except ImportError:  # imported as a top-level module (service_spec/ on
    import das_pb2   # sys.path)

_SERVICE = "das.ServiceDefinition"

# rpc name -> request message class (das.proto:49-60)
RPC_REQUEST_TYPES = {
    "create": das_pb2.BindingRequest,
    "reconnect": das_pb2.BindingRequest,
    "load_knowledge_base": das_pb2.LoadRequest,
    "check_das_status": das_pb2.DASKey,
    "clear": das_pb2.DASKey,
    "count": das_pb2.DASKey,
    "get_atom": das_pb2.AtomRequest,
    "search_nodes": das_pb2.NodeRequest,
    "search_links": das_pb2.LinkRequest,
    "query": das_pb2.Query,
}


class ServiceDefinitionStub:
    def __init__(self, channel):
        for rpc, request_type in RPC_REQUEST_TYPES.items():
            setattr(
                self,
                rpc,
                channel.unary_unary(
                    f"/{_SERVICE}/{rpc}",
                    request_serializer=request_type.SerializeToString,
                    response_deserializer=das_pb2.Status.FromString,
                ),
            )


class ServiceDefinitionServicer:
    """Default method bodies answer UNIMPLEMENTED (codegen parity)."""


def _unimplemented(request, context):
    context.set_code(grpc.StatusCode.UNIMPLEMENTED)
    context.set_details("Method not implemented!")
    raise NotImplementedError("Method not implemented!")


for _rpc in RPC_REQUEST_TYPES:
    setattr(ServiceDefinitionServicer, _rpc, staticmethod(_unimplemented))


def add_ServiceDefinitionServicer_to_server(servicer, server):
    handlers = {
        rpc: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, rpc),
            request_deserializer=request_type.FromString,
            response_serializer=das_pb2.Status.SerializeToString,
        )
        for rpc, request_type in RPC_REQUEST_TYPES.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
    )
