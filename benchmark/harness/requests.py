"""What every configuration's request generator shares: the request
record, a draw by shares and a set of distinct draws from one seed."""

from __future__ import annotations

import random
from typing import Callable, Dict, Hashable, List, NamedTuple, Sequence, Tuple

from harness.proto import encode_check_request

__all__ = ["Request", "draw_shares", "unique_draws", "encode"]


class Request(NamedTuple):
    method: str
    path: str
    host: str
    headers: Dict[str, str]


def draw_shares(rng: random.Random, shares: Sequence[Tuple[str, float]]) -> str:
    """One name of ``shares`` ((name, share), ...; shares sum to 1)."""
    r = rng.random()
    for name, share in shares:
        r -= share
        if r < 0:
            return name
    return shares[-1][0]


def unique_draws(draw: Callable[[random.Random], Hashable], n: int,
                 seed: int) -> List[Hashable]:
    """``n`` distinct results of ``draw(rng)`` in the order first drawn,
    from ``random.Random(seed)``; a repeat is drawn again."""
    rng = random.Random(seed)
    seen, out = set(), []
    tries = 0
    while len(out) < n:
        tries += 1
        if tries > 20 * n + 1000:
            raise ValueError(f"the mix has fewer than {n} distinct requests")
        d = draw(rng)
        if d not in seen:
            seen.add(d)
            out.append(d)
    return out


def encode(req: Request) -> bytes:
    return encode_check_request(req.method, req.path, req.host, req.headers)
