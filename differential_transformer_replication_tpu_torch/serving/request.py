"""Serving request/response dataclasses (a copy of the JAX package's
serving/request.py, which imports no JAX).

The unit of work for the continuous-batching engine (serving/engine.py):
a token-id prompt plus per-request sampling parameters (temperature-1
categorical by default, temperature 0 = greedy, optional top-k). Each
request carries its own ``seed``: the port draws the t-th generated
token from a ``torch.Generator`` seeded by a pure function of
``(seed, t)``, so sampled output is a function of (params, prompt,
sampling params) only, independent of slot assignment, batch
composition and admission order. ``draft_len`` caps the request's
speculative draft length, and ``RequestOutput.spec_proposed`` /
``spec_accepted`` count its drafts. Fields that belong to later slices
of the port (structured decoding, penalties, logprobs, replay offsets)
are kept so that requests validate exactly as in the JAX package; the
port's engine refuses a request that sets one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

# Priority classes, best-first. The scheduler (serving/scheduler.py)
# admits by effective rank = PRIORITY_RANK[class] - age/priority_aging_s,
# so a starved batch request eventually outranks fresh high traffic.
PRIORITY_CLASSES = ("high", "normal", "batch")
PRIORITY_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (models/generate.py:sample_token).

    Defaults reproduce the reference generation contract: temperature 1,
    no top-k (control.py:168-169). ``temperature <= 0`` means greedy
    argmax; ``top_k`` None/0 means off (negative is rejected — it used
    to slip through silently and explode inside the batched sampler).
    The full field table lives in README.md ("Structured decoding").
    """

    max_new_tokens: int = 16
    temperature: float = 1.0
    top_k: Optional[int] = None
    seed: int = 0
    # Stop token for THIS request; None defers to ServingConfig's
    # engine-wide default. The matching token is included in the output.
    eos_token_id: Optional[int] = None
    # Per-request cap on speculative draft length (serving/spec.py):
    # at most this many drafted tokens are verified per iteration for
    # this request. None = the engine's ServingConfig.spec_draft_len;
    # 0 = speculation off for this request. Caps above the engine's
    # compiled draft ladder clamp to it — per-request draft lengths
    # ride the jitted verify step as runtime arrays, never recompiling.
    draft_len: Optional[int] = None
    # ---- structured decoding (serving/constrain.py) -----------------
    # At most ONE of json_schema / regex / choices may be set. Each is
    # compiled once into a token-level FSM (cached/refcounted across
    # requests) whose per-state masks ride the jitted pool step as
    # runtime arrays — constrained traffic never recompiles.
    json_schema: Optional[str] = None  # JSON text of the schema
    regex: Optional[str] = None
    choices: Optional[tuple] = None  # tuple of candidate strings
    # ---- logit pipeline ---------------------------------------------
    # repetition_penalty: >1 divides positive / multiplies negative
    # logits of already-generated tokens (1.0 = off); presence/
    # frequency subtract flat / count-proportional penalties
    # (0.0 = off). Applied BEFORE the constraint mask and top-k.
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # Multi-token stop sequences: tuple of token-id tuples. Generation
    # finishes with finish_reason="stop_sequence" when the generated
    # tail matches any sequence (match included in the output, like
    # eos). Host-side suffix check — never touches the jitted step.
    stop: Optional[tuple] = None
    # Echo per-token logprobs: 0 = off; N>0 returns the chosen token's
    # logprob plus the top-N (id, logprob) alternatives per emitted
    # token, capped by ServingConfig.max_logprobs.
    logprobs: int = 0
    # Priority class (PRIORITY_CLASSES): "high" = interactive traffic
    # the scheduler admits first and never preempts; "batch" = bulk
    # traffic that yields its pages (mid-decode preemption to the host
    # tier) when higher classes are blocked on the pool. Anti-starvation
    # aging (ServingConfig.priority_aging_s) guarantees batch progress.
    priority: str = "normal"
    # Resume-by-replay (serving/migrate.py): the request's last
    # key_offset PROMPT tokens were emitted by an earlier attempt that
    # died mid-decode. The engine offsets the fold_in key chain by it
    # (token t samples with key position key_offset + t), seeds the
    # penalty histogram and constraint-FSM cursor from that prompt
    # tail, and matches stop sequences across the prompt/generated
    # boundary — so the continuation is bit-identical to the
    # uninterrupted run. 0 = a normal request.
    key_offset: int = 0

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )
        # type-check here, where every construction path (HTTP handler,
        # client kwargs, programmatic) funnels through: a non-int top_k
        # would otherwise only explode later inside the engine's batched
        # sampler — on the engine thread, wedging the whole server
        if self.top_k is not None and not isinstance(self.top_k, int):
            raise ValueError(f"top_k must be an int or None, got {self.top_k!r}")
        if self.top_k is not None and self.top_k < 0:
            raise ValueError(
                f"top_k must be >= 0 (0/None = off), got {self.top_k}"
            )
        if self.eos_token_id is not None and not isinstance(
            self.eos_token_id, int
        ):
            raise ValueError(
                f"eos_token_id must be an int or None, got {self.eos_token_id!r}"
            )
        if not isinstance(self.temperature, (int, float)):
            raise ValueError(
                f"temperature must be a number, got {self.temperature!r}"
            )
        if self.draft_len is not None and (
            not isinstance(self.draft_len, int) or self.draft_len < 0
        ):
            raise ValueError(
                f"draft_len must be a non-negative int or None, got "
                f"{self.draft_len!r}"
            )
        constraints = [
            k for k in ("json_schema", "regex", "choices")
            if getattr(self, k) is not None
        ]
        if len(constraints) > 1:
            raise ValueError(
                "at most one of json_schema/regex/choices may be set, "
                f"got {constraints}"
            )
        if self.json_schema is not None and not isinstance(
            self.json_schema, str
        ):
            raise ValueError(
                f"json_schema must be a JSON string, got "
                f"{self.json_schema!r}"
            )
        if self.regex is not None and not isinstance(self.regex, str):
            raise ValueError(f"regex must be a string, got {self.regex!r}")
        if self.choices is not None:
            # normalize list -> tuple so the frozen dataclass stays
            # hashable and the constraint-cache key is canonical
            if isinstance(self.choices, list):
                object.__setattr__(self, "choices", tuple(self.choices))
            if (
                not isinstance(self.choices, tuple)
                or not self.choices
                or not all(isinstance(c, str) and c for c in self.choices)
            ):
                raise ValueError(
                    "choices must be a non-empty sequence of non-empty "
                    f"strings, got {self.choices!r}"
                )
        for name in ("repetition_penalty", "presence_penalty",
                     "frequency_penalty"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)):
                raise ValueError(f"{name} must be a number, got {v!r}")
        if self.repetition_penalty <= 0:
            raise ValueError(
                "repetition_penalty must be > 0 (1.0 = off), got "
                f"{self.repetition_penalty}"
            )
        if self.stop is not None:
            if isinstance(self.stop, list):
                object.__setattr__(
                    self, "stop",
                    tuple(tuple(int(t) for t in s) for s in self.stop),
                )
            if (
                not isinstance(self.stop, tuple)
                or not self.stop
                or not all(
                    isinstance(s, tuple) and s
                    and all(isinstance(t, int) for t in s)
                    for s in self.stop
                )
            ):
                raise ValueError(
                    "stop must be a non-empty sequence of non-empty "
                    f"token-id sequences, got {self.stop!r}"
                )
        if not isinstance(self.logprobs, int) or self.logprobs < 0:
            raise ValueError(
                f"logprobs must be a non-negative int, got "
                f"{self.logprobs!r}"
            )
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"priority must be one of {PRIORITY_CLASSES}, got "
                f"{self.priority!r}"
            )
        if not isinstance(self.key_offset, int) or self.key_offset < 0:
            raise ValueError(
                f"key_offset must be a non-negative int, got "
                f"{self.key_offset!r}"
            )

    @property
    def constrained(self) -> bool:
        """Whether any structured-decoding constraint is set."""
        return (
            self.json_schema is not None
            or self.regex is not None
            or self.choices is not None
        )


@dataclass(frozen=True)
class Request:
    """One queued generation: a prompt (token ids) + sampling params."""

    request_id: int
    prompt: tuple  # token ids, length >= 1
    params: SamplingParams = field(default_factory=SamplingParams)

    @staticmethod
    def make(request_id: int, prompt: Sequence[int],
             params: Optional[SamplingParams] = None, **kw) -> "Request":
        """Convenience constructor: ``kw`` are SamplingParams fields."""
        if params is None:
            params = SamplingParams(**kw)
        elif kw:
            raise ValueError("pass params or keyword fields, not both")
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("prompt must be non-empty")
        return Request(request_id=request_id, prompt=prompt, params=params)


@dataclass
class RequestOutput:
    """Completed generation + the timestamps the bench needs.

    ``tokens`` holds only the GENERATED ids (eos included when hit);
    ``prompt`` echoes the prompt the engine actually ran — for the RoPE
    families a longer-than-block_size prompt is cropped to its last
    block_size ids, the reference's own semantics (control.py:165,
    mirrored by generate_cached, models/decode.py).
    """

    request_id: int
    prompt: List[int]
    tokens: List[int]
    # "length" | "eos" | "stop_sequence" | "constraint_complete" |
    # "constraint_dead_end" | "deadline" | "page_exhausted"
    finish_reason: str
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    # host timestamp at which each generated token was collected
    token_times: List[float] = field(default_factory=list)
    # cross-process trace id (obs/trace.py) when the request carried a
    # trace context — echoed in HTTP replies so a slow request can be
    # looked up in the stitched timeline (tools/trace_stitch.py)
    trace_id: Optional[str] = None
    # speculative-decoding accounting (serving/spec.py): draft tokens
    # the drafter proposed for this request and how many the target
    # accepted — the per-request view of the engine-wide
    # serving_spec_{proposed,accepted}_tokens_total counters. Both 0
    # when speculation was off (or never engaged) for this request.
    spec_proposed: int = 0
    spec_accepted: int = 0
    # logprob echo (params.logprobs > 0): per generated token the
    # chosen token's logprob, and the top-N (token_id, logprob)
    # alternatives — both computed on the PROCESSED logits (penalties
    # + constraint mask applied), i.e. the distribution actually
    # sampled from. None when the request did not ask for logprobs.
    token_logprobs: Optional[List[float]] = None
    top_logprobs: Optional[List[List[tuple]]] = None
    # Backoff hint for shed requests (finish_reason "page_exhausted"):
    # seconds until the pool is expected to drain enough pages, from
    # PagePool.estimated_drain_s (observed eviction/release throughput).
    # None = no estimate; HTTP Retry-After falls back to queue bounds.
    retry_after: Optional[float] = None
    # Per-request model-quality stats (obs/quality.py) when the engine
    # runs with ServingConfig.quality_telemetry: mean sampled-
    # distribution entropy and top-1 logit margin over the request's
    # FINITE per-token signals (None means every signal was "no
    # signal"), the count actually observed, the longest
    # repeat-of-previous-token run, and the spec acceptance ratio when
    # speculation engaged. None when telemetry is off.
    quality: Optional[dict] = None

    @property
    def ttft(self) -> float:
        """Time to first token (seconds)."""
        return self.first_token_time - self.submit_time

    @property
    def itls(self) -> List[float]:
        """Inter-token latencies (seconds) between consecutive tokens."""
        return [
            b - a for a, b in zip(self.token_times[:-1], self.token_times[1:])
        ]
