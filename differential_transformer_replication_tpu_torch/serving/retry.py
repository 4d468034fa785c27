"""Client-side retry with jittered exponential backoff.

The server sheds load with TYPED, retriable failures — HTTP 503 with a
``Retry-After`` header (queue full, draining, engine restarting), or
:class:`~.scheduler.QueueFullError` / :class:`~.engine.EngineCrashError`
in-process. A client that retries those naively in a tight loop defeats
the shedding (everyone re-piles-on at once); one that never retries
turns a transient restart into a user-visible failure. This module is
the well-behaved middle: full-jitter exponential backoff (the AWS
architecture-blog scheme: sleep ~ Uniform(0, min(cap, base*2^attempt)),
which decorrelates a thundering herd), FLOORED by the server's
``Retry-After`` when it sent one — the server knows how long its drain
or restart backoff actually is.

A copy of the JAX package's serving/retry.py. Pure stdlib: usable from
any client, and from the server's migration legs
(serving/server.py:``EngineRunner.migrate_out``).
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from typing import Callable, Optional, Tuple


def backoff_delay(attempt: int, base: float = 0.2, cap: float = 5.0,
                  retry_after: Optional[float] = None,
                  rng: Optional[random.Random] = None) -> float:
    """Seconds to sleep before retry number ``attempt`` (0-based).

    Full jitter over the exponential envelope, floored by the server's
    ``Retry-After`` when given — honoring it keeps clients from hammering
    a replica that told them exactly when it will be back.
    """
    envelope = min(cap, base * (2 ** attempt))
    delay = (rng or random).uniform(0.0, envelope)
    if retry_after is not None:
        delay = max(delay, retry_after)
    return delay


def call_with_retries(fn: Callable, max_retries: int = 3,
                      base: float = 0.2, cap: float = 5.0,
                      retriable: Tuple[type, ...] = (),
                      rng: Optional[random.Random] = None,
                      sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` retrying typed retriable failures; returns
    ``(result, retries_used)``. An exception carrying a ``retry_after``
    attribute (seconds) floors that retry's backoff; one whose
    ``retriable`` attribute is False is re-raised immediately even when
    its TYPE matches (a permanently failed engine raises the same class
    as a restarting one). The final attempt's exception propagates with
    ``retry_attempts`` set to the attempts burned — callers see the
    TYPED error, never a hang, and can still account for the retries."""
    attempt = 0
    while True:
        try:
            return fn(), attempt
        except retriable as e:
            if attempt >= max_retries or not getattr(e, "retriable", True):
                e.retry_attempts = attempt
                raise
            sleep(backoff_delay(
                attempt, base, cap,
                retry_after=getattr(e, "retry_after", None), rng=rng,
            ))
            attempt += 1


def http_post_json_with_retries(
    url: str, payload: dict, timeout: float = 600.0,
    max_retries: int = 3, base: float = 0.2, cap: float = 5.0,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
    deadline_s: Optional[float] = None,
    retry_after_cap: float = 30.0,
    clock: Callable[[], float] = time.monotonic,
) -> Tuple[int, dict, int]:
    """POST JSON, retrying retriable 503s (honoring ``Retry-After``)
    and transport errors with jittered backoff; returns
    ``(status, body, retries)``.

    Non-retriable statuses (400, 404, 500, 504 — a missed deadline
    will not be met by retrying either) return immediately, as does a
    503 whose body ``code`` marks it non-retriable: ``timeout`` (the
    request already burned its full generation budget; re-adding that
    load to a server at its slowest only amplifies the overload) and
    ``engine_failed`` (the replica will never recover — fail over). A
    503 with no ``code`` (a proxy, a different server) is treated as
    retriable. When the retry budget runs out the last 503 is returned
    as its status (or raised with ``retry_attempts`` set, for transport
    errors) rather than hidden.

    ``deadline_s`` budgets TOTAL elapsed time (attempts + backoffs)
    against the same deadline the server enforces: a retry whose
    backoff would land past it is not taken — the server would only
    answer 504 — and each attempt's transport timeout is clamped to
    the time remaining. Honored ``Retry-After`` values are capped at
    ``retry_after_cap`` seconds so a long drain budget (or a buggy
    header) can never park the client longer than its own deadline
    policy allows; the jittered-backoff envelope is unaffected.
    ``clock`` is injectable for tests (pairs with ``sleep``).
    """
    attempt = 0
    end = None if deadline_s is None else clock() + deadline_s
    while True:
        retry_after = None
        try:
            attempt_timeout = timeout
            if end is not None:
                attempt_timeout = max(0.001, min(timeout, end - clock()))
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=attempt_timeout) as r:
                return r.status, json.load(r), attempt
        except urllib.error.HTTPError as e:
            body = {}
            try:
                body = json.loads(e.read() or b"{}")
            except (ValueError, OSError):
                pass
            final = (
                e.code != 503
                or body.get("code") in ("timeout", "engine_failed")
                or attempt >= max_retries
            )
            if final:
                return e.code, body, attempt
            ra = e.headers.get("Retry-After")
            if ra is not None:
                try:
                    retry_after = min(float(ra), retry_after_cap)
                except ValueError:
                    pass
            delay = backoff_delay(attempt, base, cap,
                                  retry_after=retry_after, rng=rng)
            if end is not None and clock() + delay >= end:
                # the deadline would expire mid-backoff: surface the
                # last typed 503 now instead of retrying into a 504
                return e.code, body, attempt
        except (urllib.error.URLError, TimeoutError, ConnectionError,
                ValueError) as e:
            # transport-level: the server may be mid-restart; retry on
            # the same schedule, raise when the budget runs out.
            # ValueError covers a 200 whose body arrives truncated or
            # garbled (a server killed mid-response) — same class of
            # failure as the connection dying outright
            if attempt >= max_retries:
                e.retry_attempts = attempt
                raise
            delay = backoff_delay(attempt, base, cap, rng=rng)
            if end is not None and clock() + delay >= end:
                e.retry_attempts = attempt
                raise
        sleep(delay)
        attempt += 1
