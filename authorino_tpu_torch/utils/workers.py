"""Background refresh workers (ref: pkg/workers/worker.go:10-85 — ticker
goroutine with Stop()); asyncio translation used by OIDC JWKS refresh and
OPA external-registry refresh."""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional

__all__ = ["Worker", "start_worker"]

log = logging.getLogger(__name__)


class Worker:
    def __init__(self, interval_s: float, task: Callable[[], Awaitable[None]]):
        self.interval_s = interval_s
        self.task = task
        self._stopped = asyncio.Event()
        self._runner: Optional[asyncio.Task] = None

    def start(self) -> "Worker":
        self._runner = asyncio.ensure_future(self._run())
        return self

    async def _run(self):
        while not self._stopped.is_set():
            try:
                await asyncio.wait_for(self._stopped.wait(), timeout=self.interval_s)
                break
            except asyncio.TimeoutError:
                pass
            try:
                await self.task()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # refresh failures are logged, not fatal
                log.warning("worker task failed: %s", e)

    async def stop(self):
        self._stopped.set()
        if self._runner is not None:
            self._runner.cancel()
            try:
                await self._runner
            except (asyncio.CancelledError, Exception):
                pass
            self._runner = None


def start_worker(interval_s: float, task: Callable[[], Awaitable[None]]) -> Worker:
    return Worker(interval_s, task).start()
