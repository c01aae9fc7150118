"""Per-request lifecycle state machine: WAITING → PREFILL → DECODE → FINISHED.

A copy of ``repro.serving.request`` (pure Python, no framework).

The control-plane record of one serving request (DESIGN.md §10). Everything
here is host-side Python with no JAX dependency, so the scheduler invariants
(legal transitions, token accounting, page-demand bookkeeping) are property-
testable without building a model or a device pool: the hypothesis harness
in ``tests/test_serving.py`` drives thousands of random arrival/finish
schedules through :class:`Request` + :class:`repro.serving.scheduler`.

State semantics:

* ``WAITING``  — arrived, sitting in the admission queue; owns nothing.
* ``PREFILL`` — admitted to a slot; the prompt is being consumed in chunks
  of at most ``prefill_chunk`` tokens per engine step (chunked prefill:
  long prompts never monopolize a step, in-flight decodes keep going).
  The first output token is emitted by the chunk that consumes the last
  prompt token — that step stamps TTFT.
* ``DECODE``  — one output token per engine step until ``gen`` tokens.
* ``FINISHED``— evicted: pages recycled, slot freed, stream state reset.
"""

from __future__ import annotations

import dataclasses

WAITING = "WAITING"
PREFILL = "PREFILL"
DECODE = "DECODE"
FINISHED = "FINISHED"

#: legal transitions of the request state machine
_EDGES = {
    WAITING: (PREFILL,),
    PREFILL: (DECODE,),
    DECODE: (FINISHED,),
    FINISHED: (),
}


@dataclasses.dataclass
class Request:
    """One serving request's control-plane record.

    Attributes:
      req_id:      global request id (the trace/track key that survives
                   slot recycling).
      prompt_len:  prompt tokens to prefill.
      gen:         output tokens to decode (including the TTFT token).
      arrival_step: engine step the request becomes admissible.
    """

    req_id: int
    prompt_len: int
    gen: int
    arrival_step: int = 0

    # -- runtime (managed by the scheduler/engine) ---------------------------
    state: str = WAITING
    slot: int = -1
    prefilled: int = 0          # prompt tokens consumed so far
    decoded: int = 0            # output tokens emitted so far
    pages: list[int] = dataclasses.field(default_factory=list)
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1

    def __post_init__(self):
        if self.prompt_len < 1 or self.gen < 1:
            raise ValueError("prompt_len and gen must both be >= 1")

    # -- derived -------------------------------------------------------------
    @property
    def max_len(self) -> int:
        """Total context tokens at finish (prompt + generated)."""
        return self.prompt_len + self.gen

    @property
    def length(self) -> int:
        """Valid context tokens right now (prompt consumed + decoded)."""
        return self.prefilled + self.decoded

    def pages_needed(self, page_size: int) -> int:
        """Total pages this request will ever own (admission reservation)."""
        return -(-self.max_len // page_size)

    @property
    def ttft_steps(self) -> int:
        """Steps from arrival to the first output token (-1 until emitted)."""
        if self.first_token_step < 0:
            return -1
        return self.first_token_step - self.arrival_step

    # -- transitions ---------------------------------------------------------
    def to(self, state: str, step: int) -> None:
        """Move to ``state``, enforcing the lifecycle edges."""
        if state not in _EDGES[self.state]:
            raise ValueError(f"illegal transition {self.state} -> {state} "
                             f"for request {self.req_id}")
        self.state = state
        if state == PREFILL:
            self.admit_step = step
        elif state == FINISHED:
            self.finish_step = step

    def advance_prefill(self, n: int, step: int) -> int:
        """Consume up to ``n`` prompt tokens; returns tokens consumed.

        When the chunk reaches the end of the prompt the request emits its
        first output token in the same step (TTFT) and moves to DECODE.
        """
        if self.state != PREFILL:
            raise ValueError(f"request {self.req_id} not in PREFILL "
                             f"(state={self.state})")
        take = min(n, self.prompt_len - self.prefilled)
        if take <= 0:
            raise ValueError(f"request {self.req_id}: no prompt left to "
                             "prefill")
        self.prefilled += take
        if self.prefilled == self.prompt_len:
            self.decoded = 1                       # prefill emits token 0
            self.first_token_step = step
            self.to(DECODE, step)
        return take

    def advance_decode(self, step: int) -> bool:
        """Emit one output token; returns True when the quota is reached."""
        if self.state != DECODE:
            raise ValueError(f"request {self.req_id} not in DECODE "
                             f"(state={self.state})")
        if self.decoded >= self.gen:
            raise ValueError(f"request {self.req_id} decoded past its quota")
        self.decoded += 1
        return self.decoded >= self.gen
