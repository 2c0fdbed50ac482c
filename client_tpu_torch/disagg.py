"""Disaggregated prefill/decode serving: role-aware routing, verified KV
handoff, and re-prefill recovery when a decode replica dies mid-stream.

The port of ``client_tpu.disagg``, over the port's pool, arena and
clients. Production LLM fleets split compute-bound prefill from
memory-bound decode onto differently-provisioned replica classes
(Hermes, arXiv:2409.04249).
:class:`DisaggClient` / :class:`AioDisaggClient` run that split as a
client-side protocol over the existing pool machinery:

1. **Prefill leg** — routed to a ``role="prefill"`` endpoint
   (``EndpointSpec`` labels, ``pool.select(role=...)``) and executed as
   ONE pinned unary infer whose ``KV`` output lands directly in a
   shared-memory arena slab (``ShmArena.request_output``). Steady state
   does zero region creates and zero registration RPCs: the arena's
   per-``(endpoint, region)`` registration cache covers both legs after
   first use.
2. **Verified handoff** — the exported cache is summarized by a
   :class:`KvHandoff` manifest (region/offset/byte span, dtype, shape,
   fill position, first pending token) plus a blake2b digest over the
   slab bytes. The digest and manifest are re-verified immediately
   before the decode stream opens; any mismatch raises a typed
   :class:`HandoffCorrupt` — a corrupted handoff can never become
   silently-garbage tokens.
3. **Decode leg** — a ``role="decode"`` endpoint streams tokens from the
   handed-off cache (``decoder_lm_kv_decode``) through a replica-pinned
   SSE generate stream. The KV rides the generate request as a
   shared-memory *reference* (region/offset), not JSON payload.
4. **Re-prefill recovery** — a decode replica dying mid-stream is not
   the end of the session: prefill is a pure function of the token
   sequence (idempotent by construction), so the client re-runs it over
   ``prompt + already-emitted tokens`` on a healthy prefill replica,
   verifies the fresh handoff, and resumes decode on a surviving decode
   replica with ``START_INDEX`` pinned past the emitted prefix. All legs
   draw from ONE shared :class:`~client_tpu_torch.resilience.AttemptBudget`;
   the caller's stream never repeats or drops a token (an index replay
   is deduplicated and content-checked, a gap is typed). When recovery
   is impossible — budget spent, attempts exhausted, no surviving
   decode replica — a typed :class:`DecodeAbandoned` names the lost
   replica and how many tokens were already delivered.
5. **Typed role fallback** — a role with no usable endpoint at session
   start (absent, fully unavailable, or saturated) degrades to
   monolithic single-replica serving (``tiny_lm_generate`` routed
   role-less), emitting a :class:`~client_tpu_torch.pool.RoleFallback` pool
   event first. Degradation is observable, never silent.

Admission charges the two legs to SEPARATE lanes (``disagg:prefill`` /
``disagg:decode``) so a decode-heavy fleet cannot starve prefill
admission or vice versa. Every step is flight-recorded under the
``disagg`` layer (``route``, ``handoff``, ``register_check``,
``verify``, ``dedup``, ``decode_died``, ``reprefill``, ``fallback``).

Both model halves share the zoo decoder's weights and step, so the
disaggregated token stream is bit-exact against monolithic
``tiny_lm_generate`` output.

Usage::

    from client_tpu_torch.pool import EndpointSpec, PoolClient
    from client_tpu_torch.disagg import DisaggClient

    pool = PoolClient(
        [EndpointSpec("10.0.0.1:8000", role="prefill"),
         EndpointSpec("10.0.0.2:8000", role="decode"),
         EndpointSpec("10.0.0.3:8000", role="decode")],
        protocol="http", shm_arena=True)
    client = DisaggClient(pool)
    for event in client.generate_stream([3, 1, 4, 1, 5], max_tokens=32):
        print(event["INDEX"], event["NEXT_TOKEN"])
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import flight as _flight
from .arena import LeaseDigest
from ._tensor import InferInput, InferRequestedOutput
from .admission import AdmissionRejected
from .pool import (
    _PoolClientBase,
    AioPoolClient,
    EndpointSpec,
    NoEndpointAvailableError,
    PoolClient,
    RoleFallback,
)
from .resilience import (
    AttemptBudget,
    CONNECT,
    TIMEOUT,
    TRANSIENT,
    classify_fault,
)
from .utils import InferenceServerException, triton_to_np_dtype

__all__ = [
    "AioDisaggClient",
    "DecodeAbandoned",
    "DisaggClient",
    "DisaggConfigError",
    "DisaggError",
    "HandoffCorrupt",
    "KvHandoff",
    "PREFILL_ROLE",
    "DECODE_ROLE",
]

PREFILL_ROLE = "prefill"
DECODE_ROLE = "decode"

# WFQ lane labels the two legs are charged to (lazily created on the
# pool's admission controller; both at the default lane's rank so disagg
# traffic is peer to — not above — ordinary requests)
PREFILL_LANE: Tuple[str, int] = ("disagg:prefill", 1)
DECODE_LANE: Tuple[str, int] = ("disagg:decode", 1)

# blake2b-128 (collision-safe for corruption detection): the hashing
# itself now lives in arena.LeaseDigest, shared with the integrity
# layer's opt-in output-slab seals
_DIGEST_SIZE = LeaseDigest.DIGEST_SIZE


class DisaggError(InferenceServerException):
    """Base for every typed disaggregation error."""

    def __init__(self, msg: str, status: str = "DISAGG"):
        super().__init__(msg, status=status)


class DisaggConfigError(DisaggError):
    """Disaggregated serving was composed with something it rejects by
    design: a non-pool substrate, a sync/aio mismatch, a pool without
    the shm arena, or a KV contract the arena cannot stage."""

    def __init__(self, msg: str):
        super().__init__(msg, status="DISAGG_CONFIG")


class HandoffCorrupt(DisaggError):
    """The KV handoff failed verification between prefill and decode —
    digest mismatch, manifest disagreement, or a resumed stream replaying
    an index with DIFFERENT content. The session refuses to decode from
    (or emit) corrupt state; it never streams garbage tokens.

    ``field`` names what disagreed (``digest``, ``pos``, ``dtype``,
    ``shape``, ``token``); ``expected``/``actual`` carry both sides."""

    def __init__(self, url: str, field: str, expected: Any, actual: Any):
        super().__init__(
            f"KV handoff verification failed at {url or '<client>'}: "
            f"{field} expected {expected!r}, got {actual!r}",
            status="DISAGG_HANDOFF_CORRUPT")
        self.url = url
        self.field = field
        self.expected = expected
        self.actual = actual


class DecodeAbandoned(DisaggError):
    """A decode replica died mid-stream and recovery is impossible
    (attempt budget spent, failover attempts exhausted, or no healthy
    replica to re-prefill/resume on). ``url`` names the lost replica,
    ``emitted`` how many tokens the caller already received (all
    delivered exactly once), ``cause`` the terminal failure."""

    def __init__(self, url: str, emitted: int, cause: BaseException):
        super().__init__(
            f"decode replica {url} lost mid-stream after {emitted} "
            f"token(s); recovery failed: {type(cause).__name__}: {cause}",
            status="DISAGG_DECODE_ABANDONED")
        self.url = url
        self.emitted = emitted
        self.cause = cause


class KvHandoff:
    """The verified-handoff manifest: where the exported KV lives in the
    arena, what tensor it claims to be, and the blake2b digest of its
    bytes at export time. ``verify()`` recomputes the digest from the
    live slab immediately before decode — the window where a stray write
    (or a buggy re-home) could corrupt the cache."""

    __slots__ = ("region", "offset", "nbytes", "datatype", "shape",
                 "digest", "pos", "next_token", "prefill_url", "_out")

    def __init__(self, out, region: str, offset: int, nbytes: int,
                 datatype: str, shape: Sequence[int], digest: str,
                 pos: int, next_token: int, prefill_url: str):
        self._out = out  # the lease-bound InferRequestedOutput (owner)
        self.region = region
        self.offset = offset
        self.nbytes = nbytes
        self.datatype = datatype
        self.shape = list(shape)
        self.digest = digest
        self.pos = pos
        self.next_token = next_token
        self.prefill_url = prefill_url

    @property
    def lease(self):
        return getattr(self._out, "_arena_lease", None)

    def _slab_digest(self) -> str:
        lease = self.lease
        if lease is None:
            raise DisaggError("handoff lease already released",
                              status="DISAGG_HANDOFF_CORRUPT")
        return LeaseDigest(self.nbytes, self.digest).compute(lease)

    def verify(self, url: str = "") -> None:
        """Raise :class:`HandoffCorrupt` unless the live slab still hashes
        to the manifest digest."""
        actual = self._slab_digest()
        if actual != self.digest:
            raise HandoffCorrupt(url, "digest", self.digest, actual)

    def shm_reference(self) -> Dict[str, Any]:
        """The generate-extension object value referencing this handoff
        (resolved server-side exactly like infer's shm parameters)."""
        return {
            "shared_memory_region": self.region,
            "shared_memory_byte_size": self.nbytes,
            "shared_memory_offset": self.offset,
            "shape": list(self.shape),
        }

    def release(self) -> None:
        """Drop the arena lease (idempotent)."""
        out, self._out = self._out, None
        if out is not None:
            out.release_arena_lease()

    def __repr__(self) -> str:
        return (f"KvHandoff(region={self.region!r}, offset={self.offset}, "
                f"nbytes={self.nbytes}, pos={self.pos}, "
                f"digest={self.digest[:12]}..., from={self.prefill_url!r})")


class _DisaggBase:
    """Session orchestration shared by the sync and asyncio clients."""

    _AIO = False
    DEFAULT_MAX_TOKENS = 16

    def __init__(self, client: _PoolClientBase,
                 prefill_model: str = "decoder_lm_disagg_prefill",
                 decode_model: str = "decoder_lm_kv_decode",
                 fallback_model: str = "tiny_lm_generate",
                 prefill_role: str = PREFILL_ROLE,
                 decode_role: str = DECODE_ROLE):
        if not isinstance(client, _PoolClientBase):
            raise DisaggConfigError(
                f"DisaggClient needs a PoolClient/AioPoolClient substrate, "
                f"got {type(client).__name__}")
        if client._AIO != self._AIO:
            raise DisaggConfigError(
                "sync DisaggClient needs a PoolClient and AioDisaggClient "
                "an AioPoolClient (sync/aio mismatch)")
        if client.arena() is None:
            raise DisaggConfigError(
                "disaggregated serving hands the KV cache off through the "
                "shared-memory arena — build the pool with shm_arena=True")
        self.inner = client
        self.prefill_model = prefill_model
        self.decode_model = decode_model
        self.fallback_model = fallback_model
        self.prefill_role = prefill_role
        self.decode_role = decode_role
        self._kv_meta: Optional[Tuple[str, List[int]]] = None

    # -- delegation ----------------------------------------------------------
    @property
    def _FRONTEND(self) -> str:
        return "disagg+" + self.inner._FRONTEND

    def telemetry(self):
        return self.inner.telemetry()

    def arena(self):
        return self.inner.arena()

    def admission(self):
        return self.inner.admission()

    def endpoint_stats(self):
        return self.inner.endpoint_stats()

    def describe(self) -> Dict[str, Any]:
        return {
            "prefill_model": self.prefill_model,
            "decode_model": self.decode_model,
            "fallback_model": self.fallback_model,
            "prefill_role": self.prefill_role,
            "decode_role": self.decode_role,
            "roles": {str(k): v for k, v in self.inner.pool.roles().items()},
        }

    def __getattr__(self, name: str):
        if name.startswith("_") or name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    # -- shared helpers ------------------------------------------------------
    def _kv_contract(self, metadata: Dict[str, Any]) -> Tuple[str, List[int]]:
        """Resolve (and validate) the prefill model's KV output contract
        from its metadata: the arena slab is sized from it, so the shape
        must be fully static."""
        for out in metadata.get("outputs", []) or []:
            if out.get("name") == "KV":
                datatype = out.get("datatype")
                shape = [int(d) for d in out.get("shape", [])]
                if not shape or any(d < 0 for d in shape):
                    raise DisaggConfigError(
                        f"model '{self.prefill_model}' KV output shape "
                        f"{shape} is not static — the handoff slab cannot "
                        "be sized")
                if datatype == "BYTES":
                    raise DisaggConfigError(
                        "KV handoff needs a fixed-width datatype, "
                        "got BYTES")
                return datatype, shape
        raise DisaggConfigError(
            f"model '{self.prefill_model}' declares no 'KV' output — not "
            "a disaggregated prefill model")

    def _kv_nbytes(self, datatype: str, shape: Sequence[int]) -> int:
        item = np.dtype(triton_to_np_dtype(datatype)).itemsize
        return int(np.prod(shape)) * item

    @staticmethod
    def _normalize_prompt(tokens) -> List[int]:
        prompt = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if not prompt:
            raise DisaggError("empty prompt")
        return prompt

    @staticmethod
    def _fallback_reason(cause: BaseException) -> str:
        return ("saturated" if isinstance(cause, AdmissionRejected)
                else "unavailable")

    def _is_role_outage(self, exc: BaseException) -> bool:
        """Does this selection failure mean the ROLE degraded (fallback),
        rather than a client-wide admission decision (propagate)?"""
        if isinstance(exc, NoEndpointAvailableError):
            return True
        return (isinstance(exc, AdmissionRejected)
                and exc.lane == "endpoint")

    def _build_handoff(self, result, kv_out, datatype: str,
                       shape: List[int], nbytes: int, n_tokens: int,
                       url: str) -> KvHandoff:
        """Digest + manifest over the slab the prefill just filled."""
        lease = kv_out._arena_lease
        digest = LeaseDigest.seal(lease, nbytes).hexdigest
        pos = int(np.asarray(result.as_numpy("POS")).reshape(-1)[0])
        next_token = int(
            np.asarray(result.as_numpy("NEXT_TOKEN")).reshape(-1)[0])
        if pos != n_tokens:
            # the server consumed a different number of tokens than the
            # client handed it: the cache does NOT represent this prompt
            kv_out.release_arena_lease()
            raise HandoffCorrupt(url, "pos", n_tokens, pos)
        handoff = KvHandoff(
            kv_out, lease.region_name, lease.offset, nbytes, datatype,
            shape, digest, pos, next_token, url)
        _flight.note(
            "disagg", "handoff", url=url, region=lease.region_name,
            offset=lease.offset, bytes=nbytes, digest=digest, pos=pos)
        return handoff

    def _decode_payload(self, handoff: KvHandoff, emitted: List[int],
                        max_tokens: int,
                        end_id: Optional[int]) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "KV": handoff.shm_reference(),
            "POS": handoff.pos,
            "FIRST_TOKEN": handoff.next_token,
            "MAX_TOKENS": max_tokens - len(emitted),
            "START_INDEX": len(emitted),
        }
        if end_id is not None:
            payload["END_ID"] = int(end_id)
        return payload

    def _accept_event(self, event: Dict[str, Any], emitted: List[int],
                      url: str) -> Optional[Tuple[int, int]]:
        """Dedup/continuity gate for one decode stream event. Returns
        ``(token, index)`` to emit, or None when the event is a verified
        replay of an already-delivered token (skipped)."""
        token = int(event["NEXT_TOKEN"])
        index = int(event["INDEX"])
        if index < len(emitted):
            # a replayed index must carry the SAME token it did the first
            # time — same-content replays dedup silently, different
            # content is corruption, never a double emission
            if emitted[index] != token:
                raise HandoffCorrupt(url, "token", emitted[index], token)
            _flight.note("disagg", "dedup", url=url, index=index)
            return None
        if index > len(emitted):
            raise HandoffCorrupt(url, "index", len(emitted), index)
        emitted.append(token)
        return token, index

    @staticmethod
    def _finished(emitted: List[int], max_tokens: int,
                  end_id: Optional[int]) -> bool:
        if len(emitted) >= max_tokens:
            return True
        return bool(end_id is not None and emitted
                    and emitted[-1] == int(end_id))


class DisaggClient(_DisaggBase):
    """Synchronous disaggregated prefill/decode client over a
    :class:`~client_tpu_torch.pool.PoolClient` (see the module docstring for
    the full protocol). Construct with a pool, or with a list of
    urls/``EndpointSpec`` to build (and own) one."""

    _AIO = False

    def __init__(self, client: Union[PoolClient, Sequence], *,
                 protocol: str = "http", **kwargs):
        pool_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                       if k not in ("prefill_model", "decode_model",
                                    "fallback_model", "prefill_role",
                                    "decode_role")}
        owns = False
        if not hasattr(client, "infer"):
            specs = [u if isinstance(u, EndpointSpec) else EndpointSpec(u)
                     for u in client]
            pool_kwargs.setdefault("shm_arena", True)
            client = PoolClient(specs, protocol=protocol, **pool_kwargs)
            owns = True
        elif pool_kwargs:
            raise DisaggConfigError(
                "pool kwargs are only accepted when DisaggClient builds "
                "the pool itself (pass urls, not a client)")
        try:
            super().__init__(client, **kwargs)
        except BaseException:
            if owns:
                client.close()
            raise
        self._owns = owns

    def close(self) -> None:
        if self._owns:
            self.inner.close()

    def __enter__(self) -> "DisaggClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- session -------------------------------------------------------------
    def generate_stream(self, tokens, max_tokens: Optional[int] = None,
                        end_id: Optional[int] = None, *,
                        priority: int = 0,
                        client_timeout: Optional[float] = None,
                        request_id: str = ""):
        """One disaggregated generation session. Yields
        ``{"NEXT_TOKEN": int, "INDEX": int}`` events, each token exactly
        once, bit-exact vs monolithic ``tiny_lm_generate`` over the same
        prompt — through role fallback and re-prefill recovery alike."""
        prompt = self._normalize_prompt(tokens)
        budget_tokens = int(max_tokens if max_tokens is not None
                            else self.DEFAULT_MAX_TOKENS)
        if budget_tokens < 1:
            raise DisaggError("max_tokens must be >= 1")
        return self._run(prompt, budget_tokens,
                         int(end_id) if end_id is not None else None,
                         priority, client_timeout, request_id)

    def _run(self, prompt, max_tokens, end_id, priority, client_timeout,
             request_id):
        tel = self.inner.telemetry()
        scratch = _flight.layer_begin(tel, "disagg", self.decode_model)
        error: Optional[BaseException] = None
        try:
            yield from self._run_session(
                prompt, max_tokens, end_id, priority, client_timeout,
                request_id)
        except BaseException as e:
            error = e
            raise
        finally:
            if scratch is not None:
                if error is not None:
                    _flight.layer_commit(tel, scratch, error=error)
                else:
                    _flight.layer_commit(tel, scratch)

    def _run_session(self, prompt, max_tokens, end_id, priority,
                     client_timeout, request_id):
        inner = self.inner
        pool = inner.pool
        budget = AttemptBudget(inner._budget_policy, client_timeout)
        emitted: List[int] = []
        handoff: Optional[KvHandoff] = None
        d_token = None
        ctrl = inner.admission()

        # ---- first prefill (typed fallback while nothing streamed yet)
        try:
            handoff = self._prefill_leg(prompt, budget, priority,
                                        request_id)
        except (NoEndpointAvailableError, AdmissionRejected) as e:
            if not self._is_role_outage(e):
                raise
            yield from self._fallback(prompt, max_tokens, end_id,
                                      self.prefill_role, e, request_id)
            return

        dead: List[str] = []
        attempts_left = max(1, inner._max_failover_attempts)
        try:
            while not self._finished(emitted, max_tokens, end_id):
                # ---- pick a decode replica (excluding known-dead ones)
                try:
                    exclude = [ep for ep in pool.endpoints
                               if ep.url in dead]
                    dep = pool.select(role=self.decode_role,
                                      exclude=exclude)
                except (NoEndpointAvailableError, AdmissionRejected) as e:
                    if not emitted and not dead and self._is_role_outage(e):
                        handoff.release()
                        handoff = None
                        yield from self._fallback(
                            prompt, max_tokens, end_id, self.decode_role,
                            e, request_id)
                        return
                    raise DecodeAbandoned(
                        dead[-1] if dead else "<none>", len(emitted), e)

                # ---- verified handoff: digest re-checked at the last
                # moment before any token can be derived from the bytes
                handoff.verify(dep.url)
                issued = inner.arena().ensure_registered(
                    dep.client, handoff.lease._region)
                _flight.note(
                    "disagg", "register_check", url=dep.url,
                    region=handoff.region, issued=issued)
                _flight.note(
                    "disagg", "verify", url=dep.url,
                    region=handoff.region, digest=handoff.digest)
                _flight.note(
                    "disagg", "route", leg="decode", url=dep.url,
                    role=self.decode_role, resume_at=len(emitted))

                if ctrl is not None:
                    d_token = ctrl.acquire(priority or 0, budget.deadline,
                                           lane=DECODE_LANE)
                stream = inner.pinned_generate_stream(
                    dep.url, self.decode_model,
                    self._decode_payload(handoff, emitted, max_tokens,
                                         end_id),
                    request_id=request_id)
                try:
                    for event in stream:
                        accepted = self._accept_event(event, emitted,
                                                      dep.url)
                        if accepted is None:
                            continue
                        token, index = accepted
                        yield {"NEXT_TOKEN": token, "INDEX": index}
                    return  # stream drained: the session is complete
                except (DisaggError, GeneratorExit):
                    raise
                except Exception as e:
                    domain = classify_fault(e)
                    if domain not in (CONNECT, TRANSIENT, TIMEOUT):
                        raise  # an application answer, not a dead replica
                    dead.append(dep.url)
                    attempts_left -= 1
                    _flight.note(
                        "disagg", "decode_died", url=dep.url,
                        emitted=len(emitted), domain=domain,
                        attempts_left=attempts_left)
                    if attempts_left <= 0:
                        raise DecodeAbandoned(dep.url, len(emitted), e)
                    # ---- re-prefill recovery: prefill is idempotent, so
                    # prompt + emitted reproduces the lost replica's exact
                    # cache on a fresh one — all under the SAME budget
                    if self._finished(emitted, max_tokens, end_id):
                        return  # died after the final token: nothing lost
                    handoff.release()
                    handoff = None
                    if d_token is not None:
                        d_token.release()
                        d_token = None
                    _flight.note("disagg", "reprefill",
                                 emitted=len(emitted), lost=dep.url)
                    try:
                        handoff = self._prefill_leg(
                            prompt + emitted, budget, priority, request_id)
                    except Exception as e2:
                        raise DecodeAbandoned(dep.url, len(emitted),
                                              e2) from e2
                finally:
                    if d_token is not None:
                        d_token.release()
                        d_token = None
        finally:
            if handoff is not None:
                handoff.release()

    # -- legs ----------------------------------------------------------------
    def _prefill_leg(self, tokens_full: List[int], budget: AttemptBudget,
                     priority: int, request_id: str) -> KvHandoff:
        """One pinned prefill infer on a prefill-role replica; the KV
        output lands in an arena slab and comes back as a verified
        :class:`KvHandoff` (caller owns its lease)."""
        inner = self.inner
        remaining = budget.attempt_timeout_s()
        ep = inner.pool.select(role=self.prefill_role)
        _flight.note("disagg", "route", leg="prefill", url=ep.url,
                     role=self.prefill_role, tokens=len(tokens_full))
        if self._kv_meta is None:
            self._kv_meta = self._kv_contract(
                ep.client.get_model_metadata(self.prefill_model))
        datatype, shape = self._kv_meta
        nbytes = self._kv_nbytes(datatype, shape)

        inp = InferInput("TOKENS", [1, len(tokens_full)], "INT32")
        inp.set_data_from_numpy(np.asarray([tokens_full], dtype=np.int32))
        kv_out = inner.arena().request_output("KV", nbytes)
        outputs = [kv_out, InferRequestedOutput("NEXT_TOKEN"),
                   InferRequestedOutput("POS")]

        ctrl = inner.admission()
        token = None
        if ctrl is not None:
            token = ctrl.acquire(priority or 0, budget.deadline,
                                 lane=PREFILL_LANE)
        t0 = time.monotonic()
        try:
            kw: Dict[str, Any] = {"request_id": request_id}
            if remaining is not None:
                kw["client_timeout"] = remaining
            result = inner.pinned_infer(ep.url, self.prefill_model, [inp],
                                        outputs=outputs, **kw)
        except BaseException as e:
            kv_out.release_arena_lease()
            if token is not None:
                inner._admission_settle(token, t0, e)
            raise
        if token is not None:
            inner._admission_settle(token, t0, None)
        return self._build_handoff(result, kv_out, datatype, shape,
                                   nbytes, len(tokens_full), ep.url)

    def _fallback(self, prompt, max_tokens, end_id, role: str,
                  cause: BaseException, request_id: str):
        """Typed degradation to monolithic single-replica serving."""
        reason = self._fallback_reason(cause)
        self.inner.pool.emit(RoleFallback("", role, reason))
        _flight.note("disagg", "fallback", role=role, reason=reason,
                     model=self.fallback_model)
        inputs: Dict[str, Any] = {"TOKENS": [list(prompt)],
                                  "MAX_TOKENS": int(max_tokens)}
        if end_id is not None:
            inputs["END_ID"] = int(end_id)
        for event in self.inner.generate_stream(
                self.fallback_model, inputs, request_id=request_id):
            yield {"NEXT_TOKEN": int(event["NEXT_TOKEN"]),
                   "INDEX": int(event["INDEX"])}


class AioDisaggClient(_DisaggBase):
    """Asyncio twin of :class:`DisaggClient` — same protocol, same typed
    faults, async generator sessions over an
    :class:`~client_tpu_torch.pool.AioPoolClient`."""

    _AIO = True

    def __init__(self, client: Union[AioPoolClient, Sequence], *,
                 protocol: str = "http", **kwargs):
        pool_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                       if k not in ("prefill_model", "decode_model",
                                    "fallback_model", "prefill_role",
                                    "decode_role")}
        owns = False
        if not hasattr(client, "infer"):
            specs = [u if isinstance(u, EndpointSpec) else EndpointSpec(u)
                     for u in client]
            pool_kwargs.setdefault("shm_arena", True)
            client = AioPoolClient(specs, protocol=protocol, **pool_kwargs)
            owns = True
        elif pool_kwargs:
            raise DisaggConfigError(
                "pool kwargs are only accepted when AioDisaggClient builds "
                "the pool itself (pass urls, not a client)")
        try:
            super().__init__(client, **kwargs)
        except BaseException:
            if owns:
                # close() is a coroutine on the aio pool; schedule-free
                # best effort is wrong here — surface the config error,
                # the caller never saw the client
                import asyncio

                try:
                    loop = asyncio.get_running_loop()
                except RuntimeError:
                    loop = None
                if loop is not None:
                    loop.create_task(client.close())
            raise
        self._owns = owns

    async def close(self) -> None:
        if self._owns:
            await self.inner.close()

    async def __aenter__(self) -> "AioDisaggClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- session -------------------------------------------------------------
    def generate_stream(self, tokens, max_tokens: Optional[int] = None,
                        end_id: Optional[int] = None, *,
                        priority: int = 0,
                        client_timeout: Optional[float] = None,
                        request_id: str = ""):
        prompt = self._normalize_prompt(tokens)
        budget_tokens = int(max_tokens if max_tokens is not None
                            else self.DEFAULT_MAX_TOKENS)
        if budget_tokens < 1:
            raise DisaggError("max_tokens must be >= 1")
        return self._run(prompt, budget_tokens,
                         int(end_id) if end_id is not None else None,
                         priority, client_timeout, request_id)

    async def _run(self, prompt, max_tokens, end_id, priority,
                   client_timeout, request_id):
        tel = self.inner.telemetry()
        scratch = _flight.layer_begin(tel, "disagg", self.decode_model)
        error: Optional[BaseException] = None
        try:
            async for event in self._run_session(
                    prompt, max_tokens, end_id, priority, client_timeout,
                    request_id):
                yield event
        except BaseException as e:
            error = e
            raise
        finally:
            if scratch is not None:
                if error is not None:
                    _flight.layer_commit(tel, scratch, error=error)
                else:
                    _flight.layer_commit(tel, scratch)

    async def _run_session(self, prompt, max_tokens, end_id, priority,
                           client_timeout, request_id):
        inner = self.inner
        pool = inner.pool
        budget = AttemptBudget(inner._budget_policy, client_timeout)
        emitted: List[int] = []
        handoff: Optional[KvHandoff] = None
        d_token = None
        ctrl = inner.admission()

        try:
            handoff = await self._prefill_leg(prompt, budget, priority,
                                              request_id)
        except (NoEndpointAvailableError, AdmissionRejected) as e:
            if not self._is_role_outage(e):
                raise
            async for event in self._fallback(
                    prompt, max_tokens, end_id, self.prefill_role, e,
                    request_id):
                yield event
            return

        dead: List[str] = []
        attempts_left = max(1, inner._max_failover_attempts)
        try:
            while not self._finished(emitted, max_tokens, end_id):
                try:
                    exclude = [ep for ep in pool.endpoints
                               if ep.url in dead]
                    dep = pool.select(role=self.decode_role,
                                      exclude=exclude)
                except (NoEndpointAvailableError, AdmissionRejected) as e:
                    if not emitted and not dead and self._is_role_outage(e):
                        handoff.release()
                        handoff = None
                        async for event in self._fallback(
                                prompt, max_tokens, end_id,
                                self.decode_role, e, request_id):
                            yield event
                        return
                    raise DecodeAbandoned(
                        dead[-1] if dead else "<none>", len(emitted), e)

                handoff.verify(dep.url)
                issued = await inner.arena().ensure_registered_async(
                    dep.client, handoff.lease._region)
                _flight.note(
                    "disagg", "register_check", url=dep.url,
                    region=handoff.region, issued=issued)
                _flight.note(
                    "disagg", "verify", url=dep.url,
                    region=handoff.region, digest=handoff.digest)
                _flight.note(
                    "disagg", "route", leg="decode", url=dep.url,
                    role=self.decode_role, resume_at=len(emitted))

                if ctrl is not None:
                    d_token = await ctrl.acquire_async(
                        priority or 0, budget.deadline, lane=DECODE_LANE)
                stream = inner.pinned_generate_stream(
                    dep.url, self.decode_model,
                    self._decode_payload(handoff, emitted, max_tokens,
                                         end_id),
                    request_id=request_id)
                try:
                    async for event in stream:
                        accepted = self._accept_event(event, emitted,
                                                      dep.url)
                        if accepted is None:
                            continue
                        token, index = accepted
                        yield {"NEXT_TOKEN": token, "INDEX": index}
                    return
                except (DisaggError, GeneratorExit):
                    raise
                except Exception as e:
                    domain = classify_fault(e)
                    if domain not in (CONNECT, TRANSIENT, TIMEOUT):
                        raise
                    dead.append(dep.url)
                    attempts_left -= 1
                    _flight.note(
                        "disagg", "decode_died", url=dep.url,
                        emitted=len(emitted), domain=domain,
                        attempts_left=attempts_left)
                    if attempts_left <= 0:
                        raise DecodeAbandoned(dep.url, len(emitted), e)
                    if self._finished(emitted, max_tokens, end_id):
                        return
                    handoff.release()
                    handoff = None
                    if d_token is not None:
                        d_token.release()
                        d_token = None
                    _flight.note("disagg", "reprefill",
                                 emitted=len(emitted), lost=dep.url)
                    try:
                        handoff = await self._prefill_leg(
                            prompt + emitted, budget, priority, request_id)
                    except Exception as e2:
                        raise DecodeAbandoned(dep.url, len(emitted),
                                              e2) from e2
                finally:
                    if d_token is not None:
                        d_token.release()
                        d_token = None
        finally:
            if handoff is not None:
                handoff.release()

    # -- legs ----------------------------------------------------------------
    async def _prefill_leg(self, tokens_full: List[int],
                           budget: AttemptBudget, priority: int,
                           request_id: str) -> KvHandoff:
        inner = self.inner
        remaining = budget.attempt_timeout_s()
        ep = inner.pool.select(role=self.prefill_role)
        _flight.note("disagg", "route", leg="prefill", url=ep.url,
                     role=self.prefill_role, tokens=len(tokens_full))
        if self._kv_meta is None:
            self._kv_meta = self._kv_contract(
                await ep.client.get_model_metadata(self.prefill_model))
        datatype, shape = self._kv_meta
        nbytes = self._kv_nbytes(datatype, shape)

        inp = InferInput("TOKENS", [1, len(tokens_full)], "INT32")
        inp.set_data_from_numpy(np.asarray([tokens_full], dtype=np.int32))
        kv_out = inner.arena().request_output("KV", nbytes)
        outputs = [kv_out, InferRequestedOutput("NEXT_TOKEN"),
                   InferRequestedOutput("POS")]

        ctrl = inner.admission()
        token = None
        if ctrl is not None:
            token = await ctrl.acquire_async(priority or 0, budget.deadline,
                                             lane=PREFILL_LANE)
        t0 = time.monotonic()
        try:
            kw: Dict[str, Any] = {"request_id": request_id}
            if remaining is not None:
                kw["client_timeout"] = remaining
            result = await inner.pinned_infer(
                ep.url, self.prefill_model, [inp], outputs=outputs, **kw)
        except BaseException as e:
            kv_out.release_arena_lease()
            if token is not None:
                inner._admission_settle(token, t0, e)
            raise
        if token is not None:
            inner._admission_settle(token, t0, None)
        return self._build_handoff(result, kv_out, datatype, shape,
                                   nbytes, len(tokens_full), ep.url)

    async def _fallback(self, prompt, max_tokens, end_id, role: str,
                        cause: BaseException, request_id: str):
        reason = self._fallback_reason(cause)
        self.inner.pool.emit(RoleFallback("", role, reason))
        _flight.note("disagg", "fallback", role=role, reason=reason,
                     model=self.fallback_model)
        inputs: Dict[str, Any] = {"TOKENS": [list(prompt)],
                                  "MAX_TOKENS": int(max_tokens)}
        if end_id is not None:
            inputs["END_ID"] = int(end_id)
        async for event in self.inner.generate_stream(
                self.fallback_model, inputs, request_id=request_id):
            yield {"NEXT_TOKEN": int(event["NEXT_TOKEN"]),
                   "INDEX": int(event["INDEX"])}
