"""Service layer: gRPC ext_authz, raw-HTTP /check, OIDC discovery and the
CRD webhooks.  These modules and the CLI are the only ones of the port
that import ``grpc`` and ``aiohttp``."""
