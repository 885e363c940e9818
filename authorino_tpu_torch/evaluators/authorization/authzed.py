"""Authzed/SpiceDB authorization (semantics: ref
pkg/evaluators/authorization/authzed.go:25-88): gRPC CheckPermission with
subject/resource/permission resolved from the Authorization JSON.

The wire call carries the public authzed.api.v1 CheckPermission shapes,
encoded by the port's own codec (``protos/wire.py``) — no authzed client
library.  ``grpc`` is imported at the first call, so the request path and
translate import without it."""

from __future__ import annotations

from typing import Any, Optional

from ...authjson.value import JSONValue, stringify_json
from ...protos import wire
from ..base import EvaluationError

CHECK_METHOD = "/authzed.api.v1.PermissionsService/CheckPermission"
PERMISSIONSHIP_HAS_PERMISSION = 2


class Authzed:
    def __init__(
        self,
        name: str,
        endpoint: str,
        insecure: bool = False,
        shared_secret: str = "",
        subject_kind: Optional[JSONValue] = None,
        subject_name: Optional[JSONValue] = None,
        resource_kind: Optional[JSONValue] = None,
        resource_name: Optional[JSONValue] = None,
        permission: Optional[JSONValue] = None,
    ):
        self.name = name
        self.endpoint = endpoint
        self.insecure = insecure
        self.shared_secret = shared_secret
        self.subject_kind = subject_kind or JSONValue(static="")
        self.subject_name = subject_name or JSONValue(static="")
        self.resource_kind = resource_kind or JSONValue(static="")
        self.resource_name = resource_name or JSONValue(static="")
        self.permission = permission or JSONValue(static="")

    async def call(self, pipeline) -> Any:
        import grpc

        doc = pipeline.authorization_json()
        payload = wire.encode_check_permission(
            stringify_json(self.resource_kind.resolve_for(doc)),
            stringify_json(self.resource_name.resolve_for(doc)),
            stringify_json(self.permission.resolve_for(doc)),
            stringify_json(self.subject_kind.resolve_for(doc)),
            stringify_json(self.subject_name.resolve_for(doc)),
        )
        metadata = []
        if self.shared_secret:
            metadata.append(("authorization", f"Bearer {self.shared_secret}"))
        try:
            if self.insecure:
                channel = grpc.aio.insecure_channel(self.endpoint)
            else:
                channel = grpc.aio.secure_channel(
                    self.endpoint, grpc.ssl_channel_credentials()
                )
            async with channel:
                call = channel.unary_unary(
                    CHECK_METHOD,
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b,
                )
                raw = await call(payload, metadata=metadata)
        except grpc.RpcError as e:
            raise EvaluationError(f"spicedb check failed: {e}")
        permissionship = wire.decode_check_permission(raw)
        if permissionship != PERMISSIONSHIP_HAS_PERMISSION:
            raise EvaluationError("PERMISSIONSHIP_NO_PERMISSION")
        return {"permissionship": permissionship}
