"""Client-side resilience — the port's own copy of the part of
``tpudfs/common/resilience.py`` that the DFS client and its RPC layer use:
deadline propagation, tenant identity, retry budgets and circuit breakers,
and the load-shed message convention.

- **Deadlines.** The per-operation budget lives in a contextvar and rides
  outgoing RPC metadata (``x-deadline-budget``) and blockport headers
  (``_db``) as *remaining seconds*, so clock skew between hosts does not
  matter. ``RpcClient.call`` clamps each attempt's timeout to it and
  refuses to send already-expired work.
- **Tenants.** The tenant identity rides ``x-tenant`` metadata and the
  ``_tn`` blockport header; servers charge admission to it.
- **Retry budgets.** A token bucket per target address: each first attempt
  deposits ``ratio`` tokens, each retry or hedge withdraws one.
- **Circuit breakers.** Per-address closed → open → half-open state
  machines that bias read ordering away from failing replicas.

The metadata keys and message formats are the reference's byte for byte:
the servers read them, and a different key would silently drop deadlines
and tenants. The server half (load shedders, tenant QoS) is not here.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from collections.abc import Callable, Iterator

#: Metadata key carrying the remaining deadline budget in seconds (relative).
DEADLINE_KEY = "x-deadline-budget"

#: Metadata key carrying the tenant identity on the gRPC plane.
TENANT_KEY = "x-tenant"

#: Blockport frame-header key for the tenant identity.
TENANT_FRAME_KEY = "_tn"

#: The implicit tenant: control-plane traffic, background maintenance and
#: clients that never configured an identity.
SYSTEM_TENANT = "system"

#: Floor for derived per-attempt timeouts: a nearly-expired budget still
#: gets a short real timeout rather than a zero that can never succeed.
MIN_ATTEMPT_TIMEOUT = 0.01


class Deadline:
    """An absolute give-up point on the monotonic clock."""

    __slots__ = ("expires_at", "_clock")

    def __init__(self, expires_at: float,
                 clock: Callable[[], float] = time.monotonic):
        self.expires_at = expires_at
        self._clock = clock

    @classmethod
    def after(cls, budget: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + budget, clock)

    def remaining(self) -> float:
        return self.expires_at - self._clock()


_deadline: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "tpudfs_torch_deadline", default=None
)


def remaining_budget() -> float | None:
    """Seconds left on the ambient deadline, or None when none is set."""
    d = _deadline.get()
    return None if d is None else d.remaining()


@contextlib.contextmanager
def deadline_scope(budget: float | None) -> Iterator[Deadline | None]:
    """Establish a per-op deadline unless one is already active (an outer
    deadline always wins)."""
    if budget is None or _deadline.get() is not None:
        yield _deadline.get()
        return
    d = Deadline.after(budget)
    token = _deadline.set(d)
    try:
        yield d
    finally:
        _deadline.reset(token)


@contextlib.contextmanager
def shielded_from_deadline() -> Iterator[None]:
    """Clear the ambient deadline for background work (shared drainers,
    staging GC) that must not die with the caller that spawned it."""
    token = _deadline.set(None)
    try:
        yield
    finally:
        _deadline.reset(token)


class BudgetExhausted(Exception):
    """The ambient deadline expired before the next attempt could be sent."""


def attempt_timeout(timeout: float | None) -> float | None:
    """Clamp a per-attempt timeout to the ambient deadline's remaining
    budget. Raises :class:`BudgetExhausted` when the budget is spent."""
    rem = remaining_budget()
    if rem is None:
        return timeout
    if rem <= 0:
        raise BudgetExhausted("deadline budget exhausted")
    rem = max(rem, MIN_ATTEMPT_TIMEOUT)
    return rem if timeout is None else min(timeout, rem)


# ---------------------------------------------------------------------------
# Tenant identity
# ---------------------------------------------------------------------------

_tenant: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpudfs_torch_tenant", default=None
)


def raw_tenant() -> str | None:
    """The ambient tenant, or None when none was ever established."""
    return _tenant.get()


def current_tenant() -> str:
    return _tenant.get() or SYSTEM_TENANT


@contextlib.contextmanager
def tenant_scope(tenant: str | None) -> Iterator[str]:
    """Attribute the enclosed work to ``tenant`` unless an identity is
    already ambient (outer wins, as with :func:`deadline_scope`)."""
    if tenant is None or _tenant.get() is not None:
        yield current_tenant()
        return
    token = _tenant.set(tenant)
    try:
        yield tenant
    finally:
        _tenant.reset(token)


@contextlib.contextmanager
def as_system_tenant() -> Iterator[None]:
    """FORCE the system tenant for background or maintenance work, whose
    cleanup must not be throttled against the requester's quota."""
    token = _tenant.set(SYSTEM_TENANT)
    try:
        yield
    finally:
        _tenant.reset(token)


# ---------------------------------------------------------------------------
# Retry budgets
# ---------------------------------------------------------------------------


class TokenBucket:
    """Deposit-per-first-try retry throttle: first attempts deposit
    ``ratio`` tokens (capped at ``burst``), each retry withdraws one."""

    __slots__ = ("ratio", "burst", "tokens")

    def __init__(self, ratio: float = 0.5, burst: float = 10.0):
        self.ratio = ratio
        self.burst = burst
        self.tokens = burst  # start full: isolated failures get retries

    def deposit(self) -> None:
        self.tokens = min(self.burst, self.tokens + self.ratio)

    def try_spend(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class RetryBudget:
    """Per-target token buckets."""

    def __init__(self, ratio: float = 0.5, burst: float = 10.0):
        self.ratio = ratio
        self.burst = burst
        self._buckets: dict[str, TokenBucket] = {}

    def _bucket(self, key: str) -> TokenBucket:
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = TokenBucket(self.ratio, self.burst)
        return b

    def on_first_attempt(self, key: str) -> None:
        self._bucket(key).deposit()

    def acquire_retry(self, key: str) -> bool:
        return self._bucket(key).try_spend()


# ---------------------------------------------------------------------------
# Circuit breakers
# ---------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Closed → open → half-open → closed, with exponential open windows.
    ``allow()``: always in CLOSED, never while the open window runs, once
    per window in HALF_OPEN (the probe)."""

    __slots__ = ("failure_threshold", "reset_timeout", "max_reset", "_clock",
                 "state", "_failures", "_open_until", "_consecutive_opens",
                 "_probe_inflight")

    def __init__(self, failure_threshold: int = 3, reset_timeout: float = 5.0,
                 max_reset: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.max_reset = max_reset
        self._clock = clock
        self.state = CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._consecutive_opens = 0
        self._probe_inflight = False

    def allow(self) -> bool:
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() < self._open_until:
                return False
            self.state = HALF_OPEN
            self._probe_inflight = True
            return True
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        return True

    def record_success(self) -> None:
        self.state = CLOSED
        self._failures = 0
        self._consecutive_opens = 0
        self._probe_inflight = False

    def record_failure(self) -> None:
        self._probe_inflight = False
        if self.state == HALF_OPEN:
            self._trip()
            return
        self._failures += 1
        if self._failures >= self.failure_threshold:
            self._trip()

    def _trip(self) -> None:
        self.state = OPEN
        self._failures = 0
        self._consecutive_opens += 1
        window = min(self.max_reset,
                     self.reset_timeout * (2 ** (self._consecutive_opens - 1)))
        self._open_until = self._clock() + window


class BreakerBoard:
    """Per-address circuit breakers sharing one configuration."""

    def __init__(self, failure_threshold: int = 3, reset_timeout: float = 5.0,
                 max_reset: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self._cfg = (failure_threshold, reset_timeout, max_reset)
        self._clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, addr: str) -> CircuitBreaker:
        br = self._breakers.get(addr)
        if br is None:
            ft, rt, mr = self._cfg
            br = self._breakers[addr] = CircuitBreaker(ft, rt, mr, self._clock)
        return br

    def allow(self, addr: str) -> bool:
        return self.get(addr).allow()

    def record_success(self, addr: str) -> None:
        self.get(addr).record_success()

    def record_failure(self, addr: str) -> None:
        self.get(addr).record_failure()

    def healthy_first(self, addrs: list[str]) -> list[str]:
        """Stable partition: addresses with non-open breakers first.
        Ordering only — an all-open list is returned intact."""
        good = [a for a in addrs if self.get(a).state != OPEN]
        bad = [a for a in addrs if self.get(a).state == OPEN]
        return good + bad


# ---------------------------------------------------------------------------
# Load-shed message convention
# ---------------------------------------------------------------------------

#: Message prefix for RESOURCE_EXHAUSTED errors carrying a retry-after
#: hint, like the ``Not Leader|<hint>`` convention.
OVERLOADED_PREFIX = "Overloaded|"


def overloaded_message(retry_after: float, detail: str = "") -> str:
    return f"{OVERLOADED_PREFIX}{retry_after:.3f}|{detail}"


def retry_after_hint(message: str) -> float | None:
    """The retry-after seconds of an ``Overloaded|…`` message."""
    if not message.startswith(OVERLOADED_PREFIX):
        return None
    parts = message.split("|", 2)
    try:
        return float(parts[1])
    except (IndexError, ValueError):
        return None
