"""The protobuf messages the port serves and calls: Envoy ext_authz v3,
gRPC health and SpiceDB ``CheckPermission`` (``wire``), encoded and
decoded in plain Python on ``bytes``."""

from . import wire  # noqa: F401
