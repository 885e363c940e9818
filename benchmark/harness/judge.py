"""The comparison that decides ``correct``: every answer the generator
received, against the plain reference's answer to its request.

An answer is *correct* when it equals the reference's, *refused* when it
is a typed refusal (DEADLINE_EXCEEDED, RESOURCE_EXHAUSTED, UNAVAILABLE,
a gRPC error with no message, or a reset stream; a request the reference
refuses never is one) and *wrong* otherwise.  Refusals count as failed
and are not for ``correct``; a wrong answer, or a request never answered,
is.  Both limits are 0: the comparison is exact."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from harness.proto import Response, decode_check_response

REFUSAL_CODES = (4, 8, 14)
MESSAGE, NO_MESSAGE, RESET = 0, 1, 2
CORRECT, REFUSED, WRONG = "correct", "refused", "wrong"
# the numbers compared, each with its limit
LIMITS = {"wrong_answers": 0, "unanswered": 0}


@dataclass
class Variant:
    payload: int
    kind: int
    total: int
    done_in_window: int
    due_in_window: int
    data: bytes


def read_tally(path: str) -> List[Variant]:
    out = []
    with open(path, "rb") as f:
        buf = f.read()
    i = 0
    while i < len(buf):
        p, kind, total, done, due, n = struct.unpack_from("<6I", buf, i)
        i += 24
        out.append(Variant(p, kind, total, done, due, buf[i:i + n]))
        i += n
    return out


@dataclass
class Judgement:
    classes: List[str] = field(default_factory=list)   # per variant
    answers: int = 0
    correct_done_in_window: int = 0
    failed_due_in_window: int = 0
    wrong_answers: int = 0
    refused_answers: int = 0
    unanswered: int = 0
    examples: List[dict] = field(default_factory=list)

    def numbers(self) -> Dict[str, Tuple[int, int]]:
        """{name: (number, limit)} of the numbers compared."""
        return {"wrong_answers": (self.wrong_answers,
                                  LIMITS["wrong_answers"]),
                "unanswered": (self.unanswered, LIMITS["unanswered"])}

    @property
    def correct(self) -> bool:
        return all(n <= lim for n, lim in self.numbers().values())


def judge(variants: List[Variant], expected: Callable[[int], Response],
          lg: dict, stand_in: Optional[Callable[[int], Response]] = None,
          max_examples: int = 5) -> Judgement:
    """``expected(p)``: the reference's answer to payload ``p``;
    ``stand_in(p)``, when given, is put in the program's place for every
    answer that carried a message (the control)."""
    j = Judgement(unanswered=int(lg["unanswered"]))
    overflow = int(lg.get("variant_overflow", 0))
    j.wrong_answers += overflow
    for v in variants:
        want = expected(v.payload)
        if v.kind != MESSAGE:
            cls, got = REFUSED, None
        else:
            try:
                got = stand_in(v.payload) if stand_in else \
                    decode_check_response(v.data)
            except ValueError as e:
                got, cls = f"undecodable: {e}", WRONG
            else:
                cls = (CORRECT if got == want else
                       REFUSED if got.code in REFUSAL_CODES
                       and want.code not in REFUSAL_CODES else WRONG)
        j.classes.append(cls)
        j.answers += v.total
        if cls == CORRECT:
            j.correct_done_in_window += v.done_in_window
        else:
            j.failed_due_in_window += v.due_in_window
        if cls == WRONG:
            j.wrong_answers += v.total
            if len(j.examples) < max_examples:
                j.examples.append({"payload": v.payload, "answers": v.total,
                                   "got": got if isinstance(got, str)
                                   else got.to_json(),
                                   "want": want.to_json()})
        elif cls == REFUSED:
            j.refused_answers += v.total
    j.failed_due_in_window += int(lg["unanswered_due_in_window"])
    return j

