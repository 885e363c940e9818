#!/usr/bin/env python3
"""Why ``chip_smoke.py`` sends at most ``AIO_WINDOW`` Check()s in flight to
an in-process grpc.aio server.  gRPC's core cancels a call that waits
unrequested longer than ``grpc.server_max_unrequested_time_in_server``; a
grpc.aio server requests calls on the event loop that also runs each
handler's host work, so a burst sent at once leaves its last calls
unrequested for about the whole burst.  The client then reads CANCELLED,
"CANCELLED", from its peer.

This probe scales that down to run in seconds on a CPU: a grpc.aio server
with the limit lowered to ``--limit-s``, whose handler blocks its loop for
``--block-ms`` (the host work) and then awaits, takes ``--calls`` calls
through ``chip_smoke.grpc_many`` twice: all at once, then at most
``--window`` in flight.  It prints one JSON object with each pass's
seconds and its answers by status code.

    python3 grpc_window_probe.py
    python3 grpc_window_probe.py --calls 4096 --block-ms 3 --limit-s 5 \
        --window 1024
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import time

import grpc

from chip_smoke import AioLoop, grpc_many

METHOD = ("envoy.service.auth.v3.Authorization", "Check")  # CHECK_METHOD


def start_server(aio: AioLoop, block_s: float, limit_s: int):
    async def echo(request: bytes, context) -> bytes:
        time.sleep(block_s)        # the handler's host work, on the loop
        await asyncio.sleep(0.01)  # then a wait, as for a batch
        return request

    async def start():
        server = grpc.aio.server(options=[
            ("grpc.max_concurrent_streams", 10000),
            ("grpc.server_max_unrequested_time_in_server", limit_s)])
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            METHOD[0], {METHOD[1]: grpc.unary_unary_rpc_method_handler(
                echo)}),))
        port = server.add_insecure_port("127.0.0.1:0")
        await server.start()
        return server, port

    return aio.run(start())


def one_pass(aio: AioLoop, port: int, calls: int, window: int) -> dict:
    payloads = [b"%d" % k for k in range(calls)]
    t = time.perf_counter()
    out = grpc_many(aio, port, payloads, window=window)
    codes = collections.Counter(
        "OK" if raw == p else (raw.code().name if isinstance(raw, grpc.RpcError)
                               else "WRONG")
        for raw, p in zip(out, payloads))
    return {"in_flight": window or calls,
            "seconds": time.perf_counter() - t, "codes": dict(codes)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2048)
    ap.add_argument("--block-ms", type=float, default=3.0)
    ap.add_argument("--limit-s", type=int, default=2)
    ap.add_argument("--window", type=int, default=256)
    args = ap.parse_args()
    aio = AioLoop()
    server, port = start_server(aio, args.block_ms / 1e3, args.limit_s)
    try:
        passes = [one_pass(aio, port, args.calls, 0),
                  one_pass(aio, port, args.calls, args.window)]
    finally:
        aio.run(server.stop(None))
        aio.close()
    print(json.dumps({"calls": args.calls, "block_ms": args.block_ms,
                      "limit_s": args.limit_s, "passes": passes}))
    windowed_ok = passes[1]["codes"] == {"OK": args.calls}
    return 0 if windowed_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
