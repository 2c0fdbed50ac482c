"""Replayable workload traces: a versioned JSONL format + seeded generators.

Production traffic is bursty, heavy-tailed and mixed — unary infers,
SSE/decoupled generation streams and stateful sequences interleave on one
client. The closed/open-loop sweeps in ``client_tpu_torch.perf`` can't answer
"what QPS can this fleet serve inside SLO?" for that shape, so this module
gives the perf harness something replayable:

- **Format** (:class:`TraceRecord`, :func:`dump_trace` / :func:`load_trace`):
  one JSON object per line. The first line is a ``type: "header"`` record
  carrying the format version and generator provenance; every following
  line is a ``type: "request"`` record with an arrival offset (``at_s``,
  seconds from replay start), a ``kind`` (``unary`` | ``generate_stream``
  | ``sequence`` | ``sharded`` | ``prefill_decode``), the target
  model/version, and
  kind-specific payload sizing — tensor ``shapes``/``dtypes`` for unary,
  sequence and sharded records, ``prompt_tokens``/``output_tokens`` for
  streams. Sequence records carry ``(seq_group, seq_index, seq_len)`` so
  the replayer can pin each group to one replica (the pool's affinity
  rules) and issue its steps in order. ``sharded`` records (format v2,
  stamped per record so v1 loaders skip-and-count them) are logical
  scatter-gather requests replayed through ``perf.py --shard-layout``
  (``client_tpu_torch.shard``). Records may carry a ``tenant`` attribution
  (format v4, stamped per record) that the replayer threads through the
  client's admission/cache/batch layers as the multi-tenant QoS
  dimension — it never reaches the wire. ``prefill_decode`` records
  (format v5, stamped per record so v4 loaders skip-and-count them) are
  disaggregated prefill/decode sessions — ``prompt_tokens`` /
  ``output_tokens`` sizing plus optional ``prefill_role`` /
  ``decode_role`` hints — replayed through
  ``client_tpu_torch.disagg.DisaggClient`` (``perf.py --roles``).

- **Versioning**: the header's ``version`` is the format version; a
  *record* may carry its own ``v`` — records (and whole traces) from a
  NEWER format are skipped, not fatal (forward compatibility), and the
  loader reports how many it skipped. Malformed lines are fatal with the
  1-based line number (:class:`TraceParseError`).

- **Generators** (:func:`poisson_burst`, :func:`heavy_tail`,
  :func:`mixed`, :func:`multi_tenant`, or :func:`generate` from a
  ``name:k=v,...`` spec string):
  each is a pure function of ``(seed, duration, params)`` over ONE
  ``numpy.random.Generator`` — the same seed and spec always produce a
  byte-identical trace (see :func:`dumps_trace`), so traces are
  reproducible without being committed.

The replay engine lives in ``client_tpu_torch.perf`` (``--trace`` /
``--trace-gen``). This module is a copy of ``client_tpu.trace``: the same
seed and spec give a byte-identical trace file in both packages.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
from typing import Any, Dict, IO, Iterable, List, Optional, Tuple, Union

import numpy as np

# what THIS parser understands; headers are written at the BASE version so
# a v1 reader still loads the v1-compatible records of a mixed trace, and
# only records carrying newer-versioned semantics stamp their own ``v``
# (the PR 8 forward-compat rule: skip-and-count, never fatal)
TRACE_VERSION = 6
BASE_VERSION = 1
# record kinds introduced after the base format stamp their records with
# the version that introduced them
_KIND_VERSIONS = {"sharded": 2, "prefill_decode": 5, "pipeline": 6}
# records carrying a zipfian ``content_key`` (the hot-key workload knob)
# stamp v=3: a v2 loader skips exactly these, counted, and keeps the rest
_CONTENT_KEY_VERSION = 3
# records carrying a ``tenant`` attribution (the multi-tenant QoS knob)
# stamp v=4 — same rule: an older loader skips exactly the tenant-stamped
# records (counted), and tenantless specs keep producing byte-identical
# traces (no tenant field, no version stamp)
_TENANT_VERSION = 4

KINDS = ("unary", "generate_stream", "sequence", "sharded",
         "prefill_decode", "pipeline")

# default tensor layouts per well-known zoo model, so generator specs can
# name a model without restating its wire contract
_DEFAULT_LAYOUTS: Dict[str, Tuple[Dict[str, List[int]], Dict[str, str]]] = {
    "simple": ({"INPUT0": [1, 16], "INPUT1": [1, 16]},
               {"INPUT0": "INT32", "INPUT1": "INT32"}),
    "batched_matmul": ({"X": [1, 64]}, {"X": "FP32"}),
    "simple_sequence": ({"INPUT": [1, 1]}, {"INPUT": "INT32"}),
    # stateless batched prompt scoring (client_tpu_torch/shard.py's batch-axis
    # scatter-gather targets); replay tokens stay inside the VOCAB
    "decoder_lm_prefill": ({"TOKENS": [4, 8]}, {"TOKENS": "INT32"}),
    "decoder_lm_tp_prefill": ({"TOKENS": [4, 8]}, {"TOKENS": "INT32"}),
    # the pipeline chain's feed layout (client_tpu_torch/pipeline.py): the
    # record's model names the PIPELINE, shapes/dtypes its declared feeds
    "chain": ({"RAW": [1, 16]}, {"RAW": "INT32"}),
}


class TraceParseError(ValueError):
    """A malformed trace line; ``line`` is 1-based."""

    def __init__(self, line: int, message: str):
        super().__init__(f"line {line}: {message}")
        self.line = line


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One scheduled request. ``at_s`` is the arrival offset from replay
    start; replaying at speed ``s`` schedules it at ``at_s / s``."""

    at_s: float
    kind: str
    model: str
    version: str = ""
    # unary / sequence / sharded payload sizing
    shapes: Optional[Dict[str, List[int]]] = None
    dtypes: Optional[Dict[str, str]] = None
    # generate_stream payload sizing
    prompt_tokens: Optional[int] = None
    output_tokens: Optional[int] = None
    # sequence grouping: step seq_index of seq_len in group seq_group
    seq_group: Optional[int] = None
    seq_index: Optional[int] = None
    seq_len: Optional[int] = None
    # sharded records: the generator's declared fan-out (informational —
    # the replayer's --shard-layout decides the real endpoints/axes)
    shards: Optional[int] = None
    # hot-key workloads (format v3): the zipf-drawn content identity —
    # records with equal keys replay BYTE-IDENTICAL payloads (the
    # replayer synthesizes per-key deterministic tensors/prompts), so the
    # client-side cache/singleflight layer has real hot keys to collapse;
    # it also doubles as the session key for ``routing="affinity"``
    content_key: Optional[int] = None
    # multi-tenant workloads (format v4): the requesting tenant — the
    # replayer threads it as ``infer(tenant=...)`` so admission quotas,
    # weighted-fair drain and cache partitions see the same tenant mix
    # the generator declared. None (the default) stamps nothing.
    tenant: Optional[str] = None
    # prefill_decode records (format v5): role hints for the replayer's
    # DisaggClient — which pool role serves each leg. None lets the
    # replayer's own defaults ("prefill"/"decode") apply.
    prefill_role: Optional[str] = None
    decode_role: Optional[str] = None

    def to_obj(self) -> Dict[str, Any]:
        obj: Dict[str, Any] = {
            "type": "request",
            "at_s": round(float(self.at_s), 6),
            "kind": self.kind,
            "model": self.model,
        }
        if self.version:
            obj["model_version"] = self.version
        if self.shapes is not None:
            obj["shapes"] = {k: list(v) for k, v in self.shapes.items()}
            obj["dtypes"] = dict(self.dtypes or {})
        if self.kind in ("generate_stream", "prefill_decode"):
            obj["prompt_tokens"] = int(self.prompt_tokens)
            obj["output_tokens"] = int(self.output_tokens)
        if self.kind == "prefill_decode":
            if self.prefill_role is not None:
                obj["prefill_role"] = str(self.prefill_role)
            if self.decode_role is not None:
                obj["decode_role"] = str(self.decode_role)
        if self.kind == "sequence":
            obj["seq_group"] = int(self.seq_group)
            obj["seq_index"] = int(self.seq_index)
            obj["seq_len"] = int(self.seq_len)
        if self.kind == "sharded" and self.shards is not None:
            obj["shards"] = int(self.shards)
        v = _KIND_VERSIONS.get(self.kind, BASE_VERSION)
        if self.content_key is not None:
            obj["content_key"] = int(self.content_key)
            v = max(v, _CONTENT_KEY_VERSION)
        if self.tenant is not None:
            obj["tenant"] = str(self.tenant)
            v = max(v, _TENANT_VERSION)
        if v > BASE_VERSION:
            # newer-versioned records stamp their own version so an older
            # reader skips exactly these (counted) and keeps the rest
            obj["v"] = v
        return obj

    @classmethod
    def from_obj(cls, obj: Dict[str, Any], line: int) -> "TraceRecord":
        kind = obj.get("kind")
        if kind not in KINDS:
            raise TraceParseError(line, f"unknown kind {kind!r}")
        try:
            at_s = float(obj["at_s"])
        except (KeyError, TypeError, ValueError):
            raise TraceParseError(line, "missing/non-numeric at_s") from None
        if at_s < 0.0 or not math.isfinite(at_s):
            raise TraceParseError(line, f"at_s out of range: {at_s!r}")
        model = obj.get("model")
        if not model or not isinstance(model, str):
            raise TraceParseError(line, "missing model")
        kwargs: Dict[str, Any] = {
            "at_s": round(at_s, 6), "kind": kind, "model": model,
            "version": str(obj.get("model_version", "")),
        }
        if kind in ("unary", "sequence", "sharded", "pipeline") \
                and "shapes" not in obj:
            raise TraceParseError(
                line, f"{kind} requires shapes/dtypes")
        if "shapes" in obj:
            shapes = obj["shapes"]
            dtypes = obj.get("dtypes", {})
            if not isinstance(shapes, dict) or not isinstance(dtypes, dict):
                raise TraceParseError(line, "shapes/dtypes must be objects")
            try:
                kwargs["shapes"] = {
                    str(k): [int(d) for d in v] for k, v in shapes.items()}
            except (TypeError, ValueError):
                raise TraceParseError(
                    line, "shapes must map name -> [int, ...]") from None
            kwargs["dtypes"] = {str(k): str(v) for k, v in dtypes.items()}
            missing = set(kwargs["shapes"]) - set(kwargs["dtypes"])
            if missing:
                raise TraceParseError(
                    line, f"shapes without dtypes: {sorted(missing)}")
        if kind in ("generate_stream", "prefill_decode"):
            try:
                kwargs["prompt_tokens"] = int(obj["prompt_tokens"])
                kwargs["output_tokens"] = int(obj["output_tokens"])
            except (KeyError, TypeError, ValueError):
                raise TraceParseError(
                    line, f"{kind} requires integer "
                    "prompt_tokens/output_tokens") from None
            if kwargs["prompt_tokens"] < 1 or kwargs["output_tokens"] < 1:
                raise TraceParseError(line, "token counts must be >= 1")
        if kind == "prefill_decode":
            for field in ("prefill_role", "decode_role"):
                if field in obj:
                    role = obj[field]
                    if not isinstance(role, str) or not role:
                        raise TraceParseError(
                            line, f"{field} must be a non-empty string")
                    kwargs[field] = role
        if kind == "sequence":
            try:
                kwargs["seq_group"] = int(obj["seq_group"])
                kwargs["seq_index"] = int(obj["seq_index"])
                kwargs["seq_len"] = int(obj["seq_len"])
            except (KeyError, TypeError, ValueError):
                raise TraceParseError(
                    line, "sequence requires integer "
                    "seq_group/seq_index/seq_len") from None
            if not 0 <= kwargs["seq_index"] < kwargs["seq_len"]:
                raise TraceParseError(
                    line, f"seq_index {kwargs['seq_index']} outside "
                    f"seq_len {kwargs['seq_len']}")
        if kind == "sharded" and "shards" in obj:
            try:
                kwargs["shards"] = int(obj["shards"])
            except (TypeError, ValueError):
                raise TraceParseError(
                    line, "shards must be an integer") from None
            if kwargs["shards"] < 1:
                raise TraceParseError(line, "shards must be >= 1")
        if "content_key" in obj:
            try:
                kwargs["content_key"] = int(obj["content_key"])
            except (TypeError, ValueError):
                raise TraceParseError(
                    line, "content_key must be an integer") from None
            if kwargs["content_key"] < 0:
                raise TraceParseError(line, "content_key must be >= 0")
        if "tenant" in obj:
            tenant = obj["tenant"]
            if not isinstance(tenant, str) or not tenant:
                raise TraceParseError(
                    line, "tenant must be a non-empty string")
            kwargs["tenant"] = tenant
        return cls(**kwargs)


@dataclasses.dataclass
class Trace:
    """A loaded trace: header metadata + chronologically sorted records.
    ``skipped`` counts newer-version records the loader passed over."""

    header: Dict[str, Any]
    records: List[TraceRecord]
    skipped: int = 0

    @property
    def duration_s(self) -> float:
        """Nominal duration: the header's declared span, else the last
        arrival offset."""
        declared = self.header.get("duration_s")
        if declared:
            return float(declared)
        return self.records[-1].at_s if self.records else 0.0

    def kind_counts(self) -> Dict[str, int]:
        counts = {k: 0 for k in KINDS}
        for rec in self.records:
            counts[rec.kind] += 1
        return counts


# -- serialization ------------------------------------------------------------
def _record_line(obj: Dict[str, Any]) -> str:
    # sort_keys + fixed separators: serialization is a pure function of the
    # record, so generator determinism carries through to bytes on disk
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def dumps_trace(records: Iterable[TraceRecord],
                header: Optional[Dict[str, Any]] = None) -> str:
    """The trace as one JSONL string (header line first). Byte-identical
    for identical ``(records, header)`` — the determinism contract."""
    head = {"type": "header", "version": BASE_VERSION}
    head.update(header or {})
    records = list(records)
    head["records"] = len(records)
    lines = [_record_line(head)]
    lines.extend(_record_line(rec.to_obj()) for rec in records)
    return "\n".join(lines) + "\n"


def dump_trace(records: Iterable[TraceRecord],
               path_or_fp: Union[str, IO[str]],
               header: Optional[Dict[str, Any]] = None) -> None:
    text = dumps_trace(records, header)
    if hasattr(path_or_fp, "write"):
        path_or_fp.write(text)
    else:
        with open(path_or_fp, "w", encoding="utf-8") as fp:
            fp.write(text)


def loads_trace(text: str) -> Trace:
    return load_trace(io.StringIO(text))


def load_trace(path_or_fp: Union[str, IO[str]]) -> Trace:
    """Parse a JSONL trace. Malformed lines raise :class:`TraceParseError`
    with the 1-based line number; records (or a whole trace) stamped with
    a NEWER format version are skipped and counted, never fatal."""
    if hasattr(path_or_fp, "read"):
        fp = path_or_fp
        close = False
    else:
        fp = open(path_or_fp, "r", encoding="utf-8")
        close = True
    header: Dict[str, Any] = {"version": TRACE_VERSION}
    records: List[TraceRecord] = []
    skipped = 0
    try:
        for lineno, raw in enumerate(fp, start=1):
            line = raw.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceParseError(lineno, f"invalid JSON ({e.msg})") \
                    from None
            if not isinstance(obj, dict):
                raise TraceParseError(lineno, "record must be a JSON object")
            rtype = obj.get("type", "request")
            if rtype == "header":
                header = {k: v for k, v in obj.items() if k != "type"}
                continue
            # forward compatibility: a record from a newer format version
            # may carry fields with semantics this parser predates — skip
            # it (counted) instead of guessing
            v = obj.get("v", header.get("version", TRACE_VERSION))
            try:
                v = int(v)
            except (TypeError, ValueError):
                raise TraceParseError(lineno, f"non-integer version {v!r}") \
                    from None
            if v > TRACE_VERSION:
                skipped += 1
                continue
            if rtype != "request":
                skipped += 1  # unknown record types: same forward-compat rule
                continue
            records.append(TraceRecord.from_obj(obj, lineno))
    finally:
        if close:
            fp.close()
    records.sort(key=lambda r: r.at_s)
    return Trace(header=header, records=records, skipped=skipped)


# -- generators ---------------------------------------------------------------
def _modulated_rate(t: float, rate: float, burst_factor: float,
                    period_s: float, duty: float) -> float:
    """On/off modulated instantaneous rate with mean ``rate``: bursts at
    ``rate * burst_factor`` for ``duty`` of each period, with the off-phase
    rate chosen so the long-run mean stays ``rate`` (clamped at 0 when the
    burst alone exceeds the mean budget)."""
    if burst_factor <= 1.0 or duty >= 1.0:
        return rate
    phase = (t % period_s) / period_s
    if phase < duty:
        return rate * burst_factor
    return max(0.0, rate * (1.0 - burst_factor * duty) / (1.0 - duty))


def _arrival_times(rng: np.random.Generator, duration_s: float, rate: float,
                   burst_factor: float = 1.0, period_s: float = 2.0,
                   duty: float = 0.25) -> List[float]:
    """Non-homogeneous Poisson arrivals by thinning: candidates at the
    peak rate, each kept with probability ``r(t) / peak``. Pure function
    of the rng state."""
    if not (math.isfinite(duration_s) and math.isfinite(rate)
            and math.isfinite(burst_factor)):
        # the candidate loop walks to duration_s by exponential steps — a
        # non-finite bound or rate would walk forever
        raise ValueError(
            f"duration_s/rate/burst_factor must be finite "
            f"(got {duration_s!r}/{rate!r}/{burst_factor!r})")
    if burst_factor > 1.0 and burst_factor * duty > 1.0:
        # the off-phase rate clamps at 0 but cannot go negative — past
        # this point the burst excess is uncompensated and the generated
        # mean silently exceeds the declared rate (by burst_factor*duty)
        raise ValueError(
            f"burst_factor*duty must be <= 1 to preserve the declared "
            f"mean rate (got {burst_factor}*{duty} = "
            f"{burst_factor * duty:g})")
    peak = rate * max(burst_factor, 1.0)
    if peak <= 0.0 or duration_s <= 0.0:
        return []
    times: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= duration_s:
            break
        keep = float(rng.random())  # drawn unconditionally: count of draws
        # per candidate is fixed, so the stream is reproducible even if
        # the modulation params change
        if keep * peak <= _modulated_rate(t, rate, burst_factor,
                                          period_s, duty):
            times.append(round(t, 6))
    return times


def _heavy_tail_length(rng: np.random.Generator, tail: str, mean: float,
                       sigma: float, alpha: float, clip: int) -> int:
    """One heavy-tailed token count: ``lognormal`` (median ``mean``,
    shape ``sigma``) or ``pareto`` (shape ``alpha``, mean ``mean``)."""
    if tail == "pareto":
        # scale so the theoretical mean is ``mean`` (alpha > 1)
        xm = mean * (alpha - 1.0) / alpha if alpha > 1.0 else mean
        value = (1.0 + float(rng.pareto(alpha))) * xm
    else:
        value = float(rng.lognormal(math.log(max(mean, 1.0)), sigma))
    return int(min(max(round(value), 1), clip))


def _zipf_pmf(alpha: float, universe: int) -> "np.ndarray":
    """The bounded zipf distribution over key ranks 1..universe: key 0 is
    the hottest. ``alpha`` is the usual zipf exponent (1.0–1.3 matches
    measured serving fleets; higher = hotter head)."""
    if universe < 1:
        raise ValueError("hot_key_universe must be >= 1 when enabled")
    if alpha < 0.0:
        raise ValueError("hot_key_alpha must be >= 0")
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    p = ranks ** -alpha
    return p / p.sum()


def _key_rng(seed: int, content_key: int) -> np.random.Generator:
    """The per-key generator behind "same key => byte-identical payload":
    a pure function of (trace seed, key), independent of record order."""
    return np.random.default_rng((int(seed), int(content_key)))


def _layout(model: str,
            shapes: Optional[Dict[str, List[int]]] = None,
            dtypes: Optional[Dict[str, str]] = None,
            ) -> Tuple[Dict[str, List[int]], Dict[str, str]]:
    if shapes is not None:
        return shapes, dict(dtypes or {})
    if model in _DEFAULT_LAYOUTS:
        default_shapes, default_dtypes = _DEFAULT_LAYOUTS[model]
        return dict(default_shapes), dict(default_dtypes)
    raise ValueError(
        f"no default tensor layout for model {model!r}: pass shapes/dtypes")


def poisson_burst(seed: int = 0, duration_s: float = 10.0, rate: float = 50.0,
                  burst_factor: float = 4.0, period_s: float = 2.0,
                  duty: float = 0.25, model: str = "simple",
                  shapes: Optional[Dict[str, List[int]]] = None,
                  dtypes: Optional[Dict[str, str]] = None,
                  ) -> List[TraceRecord]:
    """Unary traffic whose arrival rate flips between an on-phase burst
    (``rate * burst_factor`` for ``duty`` of each ``period_s``) and a
    quiet phase, keeping the long-run mean at ``rate`` req/s."""
    rng = np.random.default_rng(seed)
    shapes, dtypes = _layout(model, shapes, dtypes)
    return [TraceRecord(at_s=t, kind="unary", model=model,
                        shapes=shapes, dtypes=dtypes)
            for t in _arrival_times(rng, duration_s, rate, burst_factor,
                                    period_s, duty)]


def heavy_tail(seed: int = 0, duration_s: float = 10.0, rate: float = 10.0,
               tail: str = "lognormal", prompt_mean: float = 24.0,
               prompt_sigma: float = 1.0, output_mean: float = 8.0,
               output_sigma: float = 0.8, alpha: float = 1.8,
               max_prompt: int = 96, max_output: int = 32,
               model: str = "tiny_lm_generate",
               hot_key_alpha: float = 1.1,
               hot_key_universe: int = 0) -> List[TraceRecord]:
    """Streamed generations with heavy-tailed prompt/output token counts
    (``lognormal`` or ``pareto``) arriving as plain Poisson at ``rate``.

    ``hot_key_universe > 0`` arms the hot-key knob: each record draws a
    ``content_key`` from a bounded zipf(``hot_key_alpha``) over
    ``hot_key_universe`` keys, its token counts then come from a per-key
    generator — same key => identical record sizing AND byte-identical
    replay payloads (the session/prefix affinity + cache proof workload).
    The default 0 draws nothing extra, so pre-v3 specs stay
    byte-identical."""
    if tail not in ("lognormal", "pareto"):
        raise ValueError(f"unknown tail {tail!r} (lognormal|pareto)")
    rng = np.random.default_rng(seed)
    pmf = _zipf_pmf(hot_key_alpha, hot_key_universe) \
        if hot_key_universe else None
    records = []
    for t in _arrival_times(rng, duration_s, rate):
        if pmf is not None:
            key = int(rng.choice(hot_key_universe, p=pmf))
            krng = _key_rng(seed, key)
            records.append(TraceRecord(
                at_s=t, kind="generate_stream", model=model,
                content_key=key,
                prompt_tokens=_heavy_tail_length(
                    krng, tail, prompt_mean, prompt_sigma, alpha,
                    max_prompt),
                output_tokens=_heavy_tail_length(
                    krng, tail, output_mean, output_sigma, alpha,
                    max_output)))
            continue
        records.append(TraceRecord(
            at_s=t, kind="generate_stream", model=model,
            prompt_tokens=_heavy_tail_length(
                rng, tail, prompt_mean, prompt_sigma, alpha, max_prompt),
            output_tokens=_heavy_tail_length(
                rng, tail, output_mean, output_sigma, alpha, max_output)))
    return records


def mixed(seed: int = 0, duration_s: float = 10.0, rate: float = 50.0,
          stream_fraction: float = 0.2, seq_fraction: float = 0.1,
          burst_factor: float = 3.0, period_s: float = 2.0,
          duty: float = 0.25, tail: str = "lognormal",
          prompt_mean: float = 24.0, prompt_sigma: float = 1.0,
          output_mean: float = 8.0, output_sigma: float = 0.8,
          alpha: float = 1.8, max_prompt: int = 96, max_output: int = 32,
          seq_len_min: int = 2, seq_len_max: int = 6,
          seq_gap_s: float = 0.05, unary_model: str = "simple",
          stream_model: str = "tiny_lm_generate",
          seq_model: str = "simple_sequence",
          shard_fraction: float = 0.0, shards: int = 2,
          shard_model: str = "decoder_lm_tp_prefill",
          shard_batch: Optional[int] = None,
          disagg_fraction: float = 0.0,
          disagg_model: str = "decoder_lm_kv_decode",
          pipeline_fraction: float = 0.0,
          pipeline_model: str = "chain",
          hot_key_alpha: float = 1.1,
          hot_key_universe: int = 0,
          shapes: Optional[Dict[str, List[int]]] = None,
          dtypes: Optional[Dict[str, str]] = None) -> List[TraceRecord]:
    """Mixed-kind bursty traffic: each Poisson-burst arrival becomes a
    stream (``stream_fraction``), a whole sequence of ``seq_len_min..max``
    steps spaced ~``seq_gap_s`` apart (``seq_fraction``), a sharded
    scatter-gather logical request (``shard_fraction``; replayed through
    ``--shard-layout``), or a unary infer (the rest). ``rate`` counts
    *arrivals* — a sequence arrival fans out into several requests, so the
    offered request rate is slightly higher. The default
    ``shard_fraction=0`` draws nothing extra from the rng, so pre-sharding
    specs keep producing byte-identical traces.

    ``hot_key_universe > 0`` arms the hot-key knob on unary AND stream
    records: a zipf(``hot_key_alpha``)-drawn ``content_key`` per record
    (format v3), threaded by the replayer into per-key deterministic
    payload synthesis (same key => byte-identical inputs) and into
    ``routing="affinity"`` session keys — the proof workload for the
    client-side cache/singleflight layer. The default 0 draws nothing
    extra, so pre-v3 specs stay byte-identical. Sequences keep their own
    group affinity and carry no key.

    ``disagg_fraction > 0`` carves a slice of arrivals into
    ``prefill_decode`` records (format v5, stamped per record so v4
    loaders skip-and-count them): disaggregated prefill/decode sessions
    the replayer drives through ``client_tpu_torch.disagg.DisaggClient``
    (``--roles``), sized by the same heavy-tail prompt/output draws as
    streams. The default 0 draws nothing extra, so pre-v5 specs keep
    producing byte-identical traces.

    ``pipeline_fraction > 0`` carves a slice of arrivals into
    ``pipeline`` records (format v6, stamped per record so v5 loaders
    skip-and-count them): client-orchestrated model-DAG runs the
    replayer drives through ``client_tpu_torch.pipeline`` (``--pipeline``).
    The record's ``model`` names the pipeline, its shapes/dtypes the
    declared feeds. The default 0 draws nothing extra, so pre-v6 specs
    keep producing byte-identical traces."""
    if (stream_fraction + seq_fraction + shard_fraction
            + disagg_fraction + pipeline_fraction > 1.0):
        raise ValueError(
            "stream_fraction + seq_fraction + shard_fraction + "
            "disagg_fraction + pipeline_fraction must be <= 1")
    if seq_len_min < 1 or seq_len_max < seq_len_min:
        raise ValueError("need 1 <= seq_len_min <= seq_len_max")
    rng = np.random.default_rng(seed)
    unary_shapes, unary_dtypes = _layout(unary_model, shapes, dtypes)
    seq_shapes, seq_dtypes = _layout(seq_model)
    shard_shapes, shard_dtypes = (
        _layout(shard_model) if shard_fraction > 0.0 else ({}, {}))
    if shard_batch is not None:
        if shard_batch < shards:
            raise ValueError(f"shard_batch {shard_batch} < shards {shards}")
        shard_shapes = {k: [int(shard_batch)] + list(v[1:])
                        for k, v in shard_shapes.items()}
    pmf = _zipf_pmf(hot_key_alpha, hot_key_universe) \
        if hot_key_universe else None
    records: List[TraceRecord] = []
    group = 0
    for t in _arrival_times(rng, duration_s, rate, burst_factor,
                            period_s, duty):
        pick = float(rng.random())
        if shard_fraction and pick >= stream_fraction + seq_fraction \
                and pick < stream_fraction + seq_fraction + shard_fraction:
            records.append(TraceRecord(
                at_s=t, kind="sharded", model=shard_model,
                shapes=shard_shapes, dtypes=shard_dtypes, shards=shards))
            continue
        disagg_lo = stream_fraction + seq_fraction + shard_fraction
        if disagg_fraction and disagg_lo <= pick \
                < disagg_lo + disagg_fraction:
            # sized exactly like a stream (same heavy-tail draws), but
            # replayed as a two-leg disaggregated session
            records.append(TraceRecord(
                at_s=t, kind="prefill_decode", model=disagg_model,
                prompt_tokens=_heavy_tail_length(
                    rng, tail, prompt_mean, prompt_sigma, alpha, max_prompt),
                output_tokens=_heavy_tail_length(
                    rng, tail, output_mean, output_sigma, alpha, max_output),
                prefill_role="prefill", decode_role="decode"))
            continue
        pipe_lo = (stream_fraction + seq_fraction + shard_fraction
                   + disagg_fraction)
        if pipeline_fraction and pipe_lo <= pick \
                < pipe_lo + pipeline_fraction:
            # one DAG run per arrival; no extra rng draws, so
            # pipeline-less specs stay byte-identical
            pipe_shapes, pipe_dtypes = _layout(pipeline_model)
            records.append(TraceRecord(
                at_s=t, kind="pipeline", model=pipeline_model,
                shapes=pipe_shapes, dtypes=pipe_dtypes))
            continue
        if pick < stream_fraction:
            if pmf is not None:
                # keyed stream: sizing comes from the per-key generator so
                # equal keys are equal sessions (prompt AND output lengths)
                key = int(rng.choice(hot_key_universe, p=pmf))
                krng = _key_rng(seed, key)
                records.append(TraceRecord(
                    at_s=t, kind="generate_stream", model=stream_model,
                    content_key=key,
                    prompt_tokens=_heavy_tail_length(
                        krng, tail, prompt_mean, prompt_sigma, alpha,
                        max_prompt),
                    output_tokens=_heavy_tail_length(
                        krng, tail, output_mean, output_sigma, alpha,
                        max_output)))
                continue
            records.append(TraceRecord(
                at_s=t, kind="generate_stream", model=stream_model,
                prompt_tokens=_heavy_tail_length(
                    rng, tail, prompt_mean, prompt_sigma, alpha, max_prompt),
                output_tokens=_heavy_tail_length(
                    rng, tail, output_mean, output_sigma, alpha, max_output)))
        elif pick < stream_fraction + seq_fraction:
            group += 1
            steps = int(rng.integers(seq_len_min, seq_len_max + 1))
            at = t
            for i in range(steps):
                records.append(TraceRecord(
                    at_s=round(at, 6), kind="sequence", model=seq_model,
                    shapes=seq_shapes, dtypes=seq_dtypes,
                    seq_group=group, seq_index=i, seq_len=steps))
                at += float(rng.exponential(seq_gap_s))
        else:
            key = (int(rng.choice(hot_key_universe, p=pmf))
                   if pmf is not None else None)
            records.append(TraceRecord(
                at_s=t, kind="unary", model=unary_model,
                shapes=unary_shapes, dtypes=unary_dtypes,
                content_key=key))
    # stable by arrival: equal offsets keep insertion order, so a group's
    # steps never reorder even when gaps round to the same microsecond
    records.sort(key=lambda r: r.at_s)
    return records


def sharded(seed: int = 0, duration_s: float = 10.0, rate: float = 20.0,
            burst_factor: float = 1.0, period_s: float = 2.0,
            duty: float = 0.25, shards: int = 2,
            model: str = "decoder_lm_tp_prefill",
            batch: Optional[int] = None,
            shapes: Optional[Dict[str, List[int]]] = None,
            dtypes: Optional[Dict[str, str]] = None) -> List[TraceRecord]:
    """Sharded logical requests arriving Poisson (optionally bursty):
    each record is ONE logical scatter-gather infer whose tensors the
    replayer splits per its ``--shard-layout`` across ``shards``
    replica-pinned endpoints (``client_tpu_torch.shard``). ``batch`` overrides
    the leading (shard) dimension of the model's default layout — spec
    strings can't carry shape dicts, and the sharded axis must be at
    least ``shards`` long. Records are stamped ``v=2`` so a v1 loader
    skips them (counted) instead of failing."""
    if shards < 1:
        raise ValueError("shards must be >= 1")
    rng = np.random.default_rng(seed)
    shapes, dtypes = _layout(model, shapes, dtypes)
    if batch is not None:
        if batch < shards:
            raise ValueError(f"batch {batch} < shards {shards}")
        shapes = {k: [int(batch)] + list(v[1:]) for k, v in shapes.items()}
    return [TraceRecord(at_s=t, kind="sharded", model=model,
                        shapes=shapes, dtypes=dtypes, shards=shards)
            for t in _arrival_times(rng, duration_s, rate, burst_factor,
                                    period_s, duty)]


def multi_tenant(seed: int = 0, duration_s: float = 10.0,
                 tenants: int = 2, rate: float = 20.0,
                 adversaries: int = 0, adversary_factor: float = 10.0,
                 burst_factor: float = 1.0, period_s: float = 2.0,
                 duty: float = 0.25, model: str = "simple",
                 hot_key_alpha: float = 1.1,
                 hot_key_universe: int = 0,
                 shapes: Optional[Dict[str, List[int]]] = None,
                 dtypes: Optional[Dict[str, str]] = None
                 ) -> List[TraceRecord]:
    """Multi-tenant unary traffic (format v4): ``tenants`` compliant
    tenants (``t0..tN-1``) each arriving Poisson at ``rate`` req/s, plus
    ``adversaries`` adversarial tenants (``adv0..``) each offering
    ``rate * adversary_factor`` — the noisy neighbor whose excess a
    quota must shed. Each tenant's arrival stream (and key draws) comes
    from its OWN child generator ``default_rng((seed, index))``, so
    adding an adversary never perturbs the compliant tenants' arrivals —
    the isolated and adversarial bench arms replay literally identical
    compliant traffic.

    ``hot_key_universe > 0`` draws a zipf ``content_key`` per record
    from a universe DELIBERATELY SHARED across tenants: two tenants
    constantly request the same hot content, so any cache hit, collapse
    or coalesce that crosses a tenant boundary would be exercised — the
    tenant-in-key isolation (``batch.plan_request``) is what this
    workload proves."""
    if tenants < 1:
        raise ValueError("tenants must be >= 1")
    if adversaries < 0:
        raise ValueError("adversaries must be >= 0")
    if adversary_factor <= 0.0:
        raise ValueError("adversary_factor must be > 0")
    shapes, dtypes = _layout(model, shapes, dtypes)
    pmf = _zipf_pmf(hot_key_alpha, hot_key_universe) \
        if hot_key_universe else None
    names = [f"t{i}" for i in range(tenants)]
    names += [f"adv{i}" for i in range(adversaries)]
    records: List[TraceRecord] = []
    for index, name in enumerate(names):
        trng = np.random.default_rng((int(seed), int(index)))
        tenant_rate = rate * (adversary_factor
                              if name.startswith("adv") else 1.0)
        for t in _arrival_times(trng, duration_s, tenant_rate,
                                burst_factor, period_s, duty):
            key = (int(trng.choice(hot_key_universe, p=pmf))
                   if pmf is not None else None)
            records.append(TraceRecord(
                at_s=t, kind="unary", model=model,
                shapes=shapes, dtypes=dtypes,
                content_key=key, tenant=name))
    # stable by arrival: equal offsets keep per-tenant insertion order
    records.sort(key=lambda r: r.at_s)
    return records


GENERATORS = {
    "poisson_burst": poisson_burst,
    "heavy_tail": heavy_tail,
    "mixed": mixed,
    "sharded": sharded,
    "multi_tenant": multi_tenant,
}

# spec params that must stay strings when parsed from a spec
_STR_PARAMS = {"model", "unary_model", "stream_model", "seq_model",
               "shard_model", "disagg_model", "pipeline_model", "tail"}


def parse_gen_spec(spec: str) -> Tuple[str, Dict[str, Any]]:
    """``name:key=value,...`` -> (generator name, kwargs). Values parse as
    int, then float, else stay strings."""
    name, _, rest = spec.partition(":")
    name = name.strip()
    if name not in GENERATORS:
        raise ValueError(
            f"unknown trace generator {name!r} "
            f"(one of {', '.join(sorted(GENERATORS))})")
    params: Dict[str, Any] = {}
    for part in filter(None, (p.strip() for p in rest.split(","))):
        key, sep, value = part.partition("=")
        if not sep:
            raise ValueError(f"malformed spec param {part!r} (want key=value)")
        key = key.strip()
        value = value.strip()
        if key in _STR_PARAMS:
            params[key] = value
            continue
        try:
            params[key] = int(value)
        except ValueError:
            try:
                params[key] = float(value)
            except ValueError:
                params[key] = value
    return name, params


def generate(spec: str, seed: int = 0,
             duration_s: Optional[float] = None) -> Trace:
    """Generate a trace from a ``name:k=v,...`` spec string. The header
    records the full provenance (spec, seed, resolved duration), so a
    written trace is self-describing and :func:`dumps_trace` of the result
    is byte-identical for identical ``(spec, seed)``. ``duration_s``
    OVERRIDES any duration in the spec — the capacity gate uses it to
    replay a shortened twin of a committed trace's workload shape."""
    name, params = parse_gen_spec(spec)
    if duration_s is not None:
        params["duration_s"] = duration_s
    try:
        records = GENERATORS[name](seed=seed, **params)
    except TypeError as e:
        raise ValueError(f"bad params for generator {name!r}: {e}") from None
    header = {
        "generator": name,
        "spec": spec,
        "seed": int(seed),
        "duration_s": params.get(
            "duration_s",
            # the generators' shared default
            10.0),
    }
    return Trace(header=header, records=records)
