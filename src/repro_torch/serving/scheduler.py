"""Admission queue + slot scheduler: the serving engine's control plane.

A copy of ``repro.serving.scheduler`` over the port's ``PageAllocator``.

Pure host-side Python over :class:`repro.serving.request.Request` and
:class:`repro.paging.kv_cache.PageAllocator` — no JAX anywhere, so the
whole admission/eviction discipline is exercisable (and hypothesis-
property-tested) without a model or a device pool.

Discipline (DESIGN.md §10):

* **Admission** is arrival-ordered and capacity-reserving: a WAITING
  request is admitted when (a) its arrival step has passed, (b) a serving
  slot is free, and (c) the allocator's free pages minus the pages already
  *reserved* by in-flight requests cover the request's full eventual need
  (``ceil((prompt+gen)/page_size)``). Reserving the whole need up front
  means an admitted request can never hit pool exhaustion mid-decode —
  admission is the only place a request can wait on memory.
* **Page growth** is incremental: prompt pages are allocated as prefill
  chunks reach them and decode extends one page at a time
  (``PageAllocator.extend_seq``), so occupancy tracks actual context
  length, not the reservation.
* **Eviction** recycles a finished request's pages through
  ``PageAllocator.recycle`` and frees its slot. Conservation — pages
  allocated == pages recycled, allocator occupancy back to baseline when
  the schedule drains — is the property test's core invariant.
"""

from __future__ import annotations

from repro_torch.paging.kv_cache import PageAllocator

from .request import DECODE, FINISHED, PREFILL, WAITING, Request


class AdmissionQueue:
    """Arrival-ordered FIFO of WAITING requests."""

    def __init__(self, requests=()):
        self._pending: list[Request] = sorted(
            requests, key=lambda r: (r.arrival_step, r.req_id))
        for r in self._pending:
            if r.state != WAITING:
                raise ValueError(f"request {r.req_id} enqueued in state "
                                 f"{r.state}")

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, req: Request) -> None:
        self._pending.append(req)
        self._pending.sort(key=lambda r: (r.arrival_step, r.req_id))

    def head_ready(self, step: int) -> Request | None:
        """The next admissible request (arrived by ``step``), FIFO order."""
        if self._pending and self._pending[0].arrival_step <= step:
            return self._pending[0]
        return None

    def pop(self) -> Request:
        return self._pending.pop(0)


class SlotScheduler:
    """Fixed slot set + capacity-reserving admission + recycling eviction.

    Args:
      n_slots: concurrent serving slots (the tiered data path's stream
        count — fixed shapes; a slot with no request sweeps nothing).
      allocator: the shared :class:`PageAllocator` over the cold pool.
      page_size: tokens per KV page.
      gang: lock-step admission mode (the baseline the continuous engine
        is benchmarked against): requests are only admitted when *every*
        slot is free, then as many arrived requests as fit are ganged in
        together — the fixed-batch prefill→decode serving loop this
        refactor replaces.
    """

    def __init__(self, n_slots: int, allocator: PageAllocator,
                 page_size: int, gang: bool = False):
        self.n_slots = n_slots
        self.allocator = allocator
        self.page_size = page_size
        self.gang = gang
        self.slots: list[Request | None] = [None] * n_slots
        self.reserved = 0            # pages promised to admitted requests
        self.pages_allocated = 0     # conservation counters
        self.pages_recycled = 0

    # -- introspection -------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def headroom(self) -> int:
        """Unreserved free pages available to new admissions."""
        return self.allocator.free_count - self.reserved

    # -- admission -----------------------------------------------------------
    def can_admit(self, req: Request) -> bool:
        return req.pages_needed(self.page_size) <= self.headroom()

    def admit_ready(self, queue: AdmissionQueue, step: int) -> list[Request]:
        """Admit arrived requests into free slots (FIFO, head-of-line).

        Returns the requests admitted this step, already transitioned to
        PREFILL and bound to their slots. Admission stops at the first
        request that does not fit (no reordering past the head — arrival
        order is the fairness contract).
        """
        if self.gang and any(r is not None for r in self.slots):
            return []
        admitted = []
        free = self.free_slots()
        while free:
            req = queue.head_ready(step)
            if req is None or not self.can_admit(req):
                break
            queue.pop()
            slot = free.pop(0)
            if self.slots[slot] is not None:
                raise RuntimeError(f"slot {slot} double-occupancy")
            req.slot = slot
            req.to(PREFILL, step)
            self.reserved += req.pages_needed(self.page_size)
            self.slots[slot] = req
            admitted.append(req)
        return admitted

    # -- page growth ---------------------------------------------------------
    def page_for_position(self, req: Request, position: int) -> int:
        """Physical page holding ``position``, extending the request's
        allocation when the position crosses into a new page. Draws down
        the admission reservation page by page."""
        idx = position // self.page_size
        if idx > len(req.pages):
            raise ValueError(f"request {req.req_id}: position {position} "
                             f"skips page {len(req.pages)}")
        if idx == len(req.pages):
            (page,) = self.allocator.extend_seq(req.req_id, 1)
            req.pages.append(page)
            self.reserved -= 1
            self.pages_allocated += 1
        return req.pages[idx]

    # -- eviction ------------------------------------------------------------
    def finish(self, req: Request, step: int) -> int:
        """Evict a DECODE-complete request: recycle pages, free the slot.

        Returns the number of pages recycled (asserted == pages owned).
        """
        if req.state != DECODE or req.decoded < req.gen:
            raise ValueError(f"request {req.req_id} not finishable "
                             f"(state={req.state}, {req.decoded}/{req.gen})")
        req.to(FINISHED, step)
        n_owned = len(req.pages)
        n = self.allocator.recycle(req.pages)
        if n != n_owned:
            raise RuntimeError(
                f"request {req.req_id}: recycled {n} of {n_owned} pages — "
                "a page was yanked by someone else mid-flight")
        # hand back the unused tail of the reservation (requests whose
        # final decode token never writes a page keep a page in reserve)
        self.reserved -= req.pages_needed(self.page_size) - n_owned
        self.pages_recycled += n
        self.slots[req.slot] = None
        return n
