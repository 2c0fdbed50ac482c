"""``python -m client_tpu_torch.doctor`` — a one-command fleet snapshot.

The port of ``client_tpu.doctor``: the same sections, anomaly flags,
``kind`` strings and rendered text. The device shared-memory family is
``cuda`` (the server's ``get_cuda_shared_memory_status`` and
``utils.cuda_shared_memory.region_inventory()``) where JAX's is ``tpu``.

Answers "what is the fleet doing right now" in one shot: endpoint
health and breaker states, SLO status and burn rates, windowed TTFT/ITL
sketches, batch-dispatcher stats, the shm inventory and data-plane
accounting, per-endpoint ORCA load, a client/server/network latency
decomposition from a small probe load, and a clock-skew estimate from
trace joins — emitted as a human-readable summary plus a JSON artifact,
with anomaly flags (breaker open, SLO breach, shm churn above threshold,
load/latency divergence, clock skew, admission collapse). When the
passed telemetry carries attached admission controllers
(``PoolClient(admission=...)``), the snapshot gains an ``admission``
section (limit/inflight/per-lane sheds) and an ``admission_collapse``
anomaly fires when a limit is pinned at its floor while an SLO burns.

CLI::

    python -m client_tpu_torch.doctor 127.0.0.1:8000 127.0.0.1:8001 \
        --protocol http --model simple --json doctor.json

Library::

    from client_tpu_torch.doctor import collect_snapshot, render_summary
    snap = collect_snapshot(["127.0.0.1:8000"], telemetry=my_telemetry)

When an existing :class:`~client_tpu_torch.observe.Telemetry` is passed, its
declared SLOs, stream windows and batch instruments are reported; the CLI
builds a fresh one (so those sections reflect only the probe run).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from . import observe
from .observe import StatsCorrelator, Telemetry
from .pool import EndpointSpec, PoolClient
from .utils import InferenceServerException, sorted_percentile, triton_to_np_dtype

__all__ = ["collect_snapshot", "postmortem_bundle", "render_summary",
           "main"]


def _input_module(protocol: str):
    if protocol == "http":
        import client_tpu_torch.http as mod
    elif protocol == "grpc":
        import client_tpu_torch.grpc as mod
    else:
        raise ValueError(f"unknown protocol {protocol!r} (http|grpc)")
    return mod


def _bounded_client_factory(protocol: str,
                            timeout_s: float) -> Callable[[str], Any]:
    """Doctor clients with every transport call bounded by the probe
    timeout: a replica that accepts TCP but never answers (the blackhole
    fault) must cost one timeout per call, not the transport's 60 s
    default times every snapshot RPC. HTTP bounds at the connection
    pool; gRPC calls carry per-call deadlines (see _bounded_call)."""
    mod = _input_module(protocol)
    if protocol == "http":
        return lambda url: mod.InferenceServerClient(
            url, connection_timeout=timeout_s, network_timeout=timeout_s)
    return lambda url: mod.InferenceServerClient(url)


def _bounded_call(fn: Callable, *args, timeout_s: float, **kwargs) -> Any:
    """Call a transport method with ``client_timeout=`` when it takes one
    (gRPC); HTTP methods are already bounded by the factory's pool
    timeouts."""
    if observe.accepts_client_timeout(fn):
        return fn(*args, client_timeout=timeout_s, **kwargs)
    return fn(*args, **kwargs)


def _synth_inputs(mod, metadata: Dict[str, Any]) -> List[Any]:
    """Build one InferInput per declared model input, with dynamic (-1)
    dims collapsed to 1 and deterministic fill data — enough to drive a
    representative probe infer against any served model."""
    inputs = []
    for spec in metadata.get("inputs", []):
        shape = [1 if int(d) < 0 else int(d) for d in spec.get("shape", [])]
        datatype = spec.get("datatype", "FP32")
        inp = mod.InferInput(spec.get("name", ""), shape, datatype)
        n = int(np.prod(shape)) if shape else 1
        if datatype == "BYTES":
            data = np.array([b"doctor"] * n, dtype=np.object_).reshape(shape)
        else:
            np_dtype = np.dtype(triton_to_np_dtype(datatype))
            data = np.ones(n, dtype=np_dtype).reshape(shape)
        inp.set_data_from_numpy(data)
        inputs.append(inp)
    return inputs


def _probe_endpoint(ep, mod, model: str, requests: int,
                    timeout_s: float) -> Dict[str, Any]:
    """Health-probe one endpoint, then drive ``requests`` probe infers on
    its client (telemetry + ORCA ride along automatically). The LAST
    infer is wall-clock bracketed for the skew estimate."""
    out: Dict[str, Any] = {"url": ep.url}
    try:
        out["live"] = bool(ep.client.is_server_live(
            probe=True, client_timeout=timeout_s))
        out["ready"] = bool(ep.client.is_server_ready(
            probe=True, client_timeout=timeout_s))
    except InferenceServerException as e:
        out["live"] = out["ready"] = False
        out["health_error"] = str(e)[:200]
    if not out["ready"]:
        return out
    try:
        metadata = _bounded_call(ep.client.get_model_metadata, model,
                                 timeout_s=timeout_s)
        inputs = _synth_inputs(mod, metadata)
    except Exception as e:
        out["probe_error"] = f"metadata: {e}"[:200]
        return out
    latencies: List[float] = []
    errors = 0
    skew_id = f"doctor-skew-{ep.url}"
    wall_t0 = wall_t1 = None
    for i in range(max(requests, 1)):
        last = i == max(requests, 1) - 1
        t0 = time.perf_counter()
        if last:
            wall_t0 = time.time()
        try:
            ep.client.infer(model, inputs, client_timeout=timeout_s,
                            request_id=skew_id if last else f"doctor-{i}")
        except Exception as e:
            errors += 1
            out.setdefault("probe_error", str(e)[:200])
            continue
        if last:
            wall_t1 = time.time()
        latencies.append(time.perf_counter() - t0)
    out["probe_requests"] = len(latencies)
    out["probe_errors"] = errors
    if latencies:
        ordered = sorted(latencies)
        out["probe_latency_ms"] = {
            "avg": round(sum(ordered) / len(ordered) * 1e3, 3),
            "p50": round(sorted_percentile(ordered, 0.5) * 1e3, 3),
            "max": round(ordered[-1] * 1e3, 3),
        }
    # -- clock skew from the trace join (HTTP transports expose the
    # access records at /v2/trace/access; wall_time_s is stamped at the
    # server's end of handling, so the client-side bracket bounds it)
    if wall_t0 is not None and wall_t1 is not None:
        record = _find_access_record(ep.client, skew_id)
        if record is not None and "wall_time_s" in record:
            midpoint = (wall_t0 + wall_t1) / 2.0
            out["clock_skew_ms"] = round(
                (record["wall_time_s"] - midpoint) * 1e3, 3)
            out["clock_skew_uncertainty_ms"] = round(
                (wall_t1 - wall_t0) / 2.0 * 1e3, 3)
            out["server_span"] = {
                "queue_ns": record.get("queue_ns"),
                "compute_ns": record.get("compute_ns"),
                "total_ns": record.get("total_ns"),
            }
    return out


def _find_access_record(client, request_id: str) -> Optional[Dict[str, Any]]:
    get = getattr(client, "_get", None)  # sync HTTP transport only
    if get is None:
        return None
    try:
        resp = get("v2/trace/access")
        if resp.status != 200:
            return None
        records = json.loads(resp.data)
    except Exception:
        return None
    for record in reversed(records):
        if record.get("request_id") == request_id:
            return record
    return None


def _server_shm_status(client, timeout_s: float) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for family, getter in (
            ("system", "get_system_shared_memory_status"),
            ("cuda", "get_cuda_shared_memory_status")):
        try:
            out[family] = _bounded_call(getattr(client, getter),
                                        timeout_s=timeout_s)
        except Exception as e:
            out[family] = {"error": str(e)[:200]}
    return out


def _total_dataplane_ops(dp: Dict[str, Any]) -> float:
    """Every lifecycle op + registration RPC in one recorder snapshot."""
    total = 0.0
    for fam in dp.get("families", {}).values():
        total += (fam["created"] + fam["attached"] + fam["map_reads"]
                  + fam["map_writes"] + fam["destroyed"])
    total += sum(dp.get("rpcs", {}).values())
    return total


def _local_shm(recorder) -> Dict[str, Any]:
    from .utils import cuda_shared_memory, shared_memory

    inventory = (shared_memory.region_inventory()
                 + cuda_shared_memory.region_inventory())
    return {
        "local_inventory": inventory,
        "dataplane": recorder.snapshot() if recorder is not None else None,
        "arena": _arena_status(),
    }


def _arena_status() -> List[Dict[str, Any]]:
    """One row per live ShmArena: slab/byte residency, hit rates, and the
    registration cache grouped per endpoint (empty list = no arenas)."""
    import sys

    arena_mod = sys.modules.get("client_tpu_torch.arena")
    if arena_mod is None:
        return []
    rows = []
    for a in arena_mod.arenas():
        try:
            rows.append({
                "stats": a.stats(),
                "regions": a.inventory(),
                "registration_cache": a.registration_entries(),
            })
        except Exception as e:
            rows.append({"error": str(e)[:200]})
    return rows


def _arena_leased_bytes() -> int:
    """Total leased bytes across every live arena (leak-flag baseline)."""
    import sys

    arena_mod = sys.modules.get("client_tpu_torch.arena")
    if arena_mod is None:
        return 0
    total = 0
    for a in arena_mod.arenas():
        try:
            total += a.stats()["leased_bytes"]
        except Exception:
            pass
    return total


def _cache_status() -> List[Dict[str, Any]]:
    """One row per live response cache (``client_tpu_torch.cache``): hit rate,
    resident bytes, evictions by reason. Empty when the process never
    loaded the cache layer — lazy, like the arena section."""
    import sys

    cache_mod = sys.modules.get("client_tpu_torch.cache")
    if cache_mod is None:
        return []
    rows = []
    for c in cache_mod.caches():
        try:
            rows.append(c.stats())
        except Exception as e:
            rows.append({"error": str(e)[:200]})
    return rows


def _tenancy_status() -> List[Dict[str, Any]]:
    """One row per live tenancy policy (``client_tpu_torch.tenancy``): per-tenant
    admitted/shed totals, quota token level, SLO burn window and the
    noisy-neighbor verdicts. Empty when the process never loaded the
    tenancy layer — lazy, like the cache section."""
    import sys

    tenancy_mod = sys.modules.get("client_tpu_torch.tenancy")
    if tenancy_mod is None:
        return []
    rows = []
    for policy in tenancy_mod.policies():
        try:
            rows.append(policy.snapshot())
        except Exception as e:
            rows.append({"error": str(e)[:200]})
    return rows


def _flight_status(tel: Telemetry) -> Optional[Dict[str, Any]]:
    """The flight-recorder section: retention accounting, the rolling
    tail-divergence verdict, and the newest anomalous timelines in
    summary form (trace id, verdict, duration, dominant attribution) —
    full timelines ship in the ``--postmortem`` bundle, not the
    snapshot."""
    recorder = getattr(tel, "flight", None)
    if recorder is None:
        return None
    anomalies = []
    for row in recorder.last_anomalies(8):
        anomalies.append({
            "trace_id": row["trace_id"],
            "verdict": row["verdict"],
            "model": row["model"],
            "duration_ms": row["duration_ms"],
            "error": row["error"],
            "events": len(row["events"]),
            "dominant": row["attribution"]["dominant"],
        })
    return {
        "stats": recorder.stats(),
        "tail_divergence": recorder.tail_divergence(),
        "last_anomalies": anomalies,
    }


def _federation_status(tel: Telemetry) -> List[Dict[str, Any]]:
    """One row per federation attached to the telemetry (the federation
    wires itself in at construction): per-cell role/health/breaker/spill
    state plus the shadow and canary views. Empty when no multi-cell
    client is armed."""
    rows = []
    for fed, scope in getattr(tel, "federations", lambda: [])():
        try:
            row = dict(fed.federation_stats())
        except Exception as e:
            row = {"error": str(e)[:200]}
        row["scope"] = scope
        rows.append(row)
    return rows


def _admission_status(tel: Telemetry) -> List[Dict[str, Any]]:
    """One row per admission controller attached to the telemetry (the
    pool wires its controller in at construction): limit, inflight,
    per-lane queue depth and shed counts. Empty when nothing is armed."""
    rows = []
    for ctrl, scope in tel.admission_controllers():
        try:
            row = dict(ctrl.snapshot())
        except Exception as e:
            row = {"error": str(e)[:200]}
        row["scope"] = scope
        rows.append(row)
    return rows


def _slo_status(tel: Telemetry) -> List[Dict[str, Any]]:
    return [
        {
            "name": slo.name,
            "metric": slo.metric,
            "threshold_ms": slo.threshold_ms,
            "objective": slo.objective,
            "window_s": slo.window_s,
            "burn_rate": round(slo.burn_rate(), 4),
            "breached": slo.breached(),
        }
        for slo in tel.slos()
    ]


def _shard_section(layout, snap: Dict[str, Any]) -> Dict[str, Any]:
    """Shard topology: the layout's declaration plus each pinned
    endpoint's probed health/ejection/breaker state, in shard order."""
    by_url = {ep["url"]: ep for ep in snap.get("endpoints", [])}
    stats = snap.get("endpoint_stats", {})
    shards = []
    for i, url in enumerate(layout.endpoints):
        ep = by_url.get(url, {})
        st = stats.get(url, {})
        shards.append({
            "shard": i,
            "url": url,
            "live": bool(ep.get("live")),
            "ready": bool(ep.get("ready")),
            "ejected": bool(st.get("ejected")),
            "breaker_state": st.get("breaker_state"),
            "outstanding": st.get("outstanding"),
        })
    return {"layout": layout.describe(), "shards": shards}


def _pipeline_section(pipeline, urls, protocol, client_factory,
                      timeout_s: float, runs: int = 4) -> Dict[str, Any]:
    """Probe the declared model DAG: run it a few times through a
    flight-armed PipelineClient over the fleet and report the waterfall
    — per-stage latencies, each run's dominant flight-attribution key
    (``pipeline:<stage>``), and the slab plan's high-water versus the
    arena residency the probe actually observed."""
    from .flight import FlightRecorder
    from .pipeline import PipelineClient

    feeds = {}
    for name, (dtype, shape) in pipeline.inputs.items():
        concrete = [1 if int(d) < 0 else int(d) for d in shape]
        np_dtype = triton_to_np_dtype(dtype)
        if np_dtype is None or np_dtype == np.object_:
            feeds[name] = np.full(concrete, b"0", dtype=np.object_)
        else:
            feeds[name] = np.ones(concrete, dtype=np_dtype)
    recorder = FlightRecorder(baseline_ratio=1.0)
    tel = Telemetry(sample="always", flight=recorder)
    section: Dict[str, Any] = {
        "pipeline": pipeline.name,
        "stages": list(pipeline.order),
        "runs": 0,
        "errors": [],
    }
    client = None
    try:
        client = PipelineClient(
            list(urls), pipeline, protocol=protocol, telemetry=tel,
            health_interval_s=None, client_factory=client_factory)
        try:
            # one unmeasured warmup run: the first execution bills every
            # stage's jit compile, which would crown a fake hot stage
            client.run(feeds, client_timeout=timeout_s)
        except InferenceServerException:
            pass  # a genuinely broken DAG will show up measured
        warm_seqs = {t.seq for t in recorder.retained()}
        samples: Dict[str, List[float]] = {}
        for _ in range(max(1, runs)):
            try:
                res = client.run(feeds, client_timeout=timeout_s)
                section["runs"] += 1
                for sname, lat_s in res.stage_latency_s.items():
                    samples.setdefault(sname, []).append(lat_s * 1e3)
            except InferenceServerException as e:
                section["errors"].append(str(e))
        section["stage_ms"] = {
            sname: {
                "count": len(vals),
                "avg_ms": round(sum(vals) / len(vals), 3),
                "p50_ms": round(sorted_percentile(sorted(vals), 0.50), 3),
                "max_ms": round(max(vals), 3),
            }
            for sname, vals in samples.items()}
        stats = client.stats()
        section["plan_high_water_bytes"] = stats.get(
            "plan_high_water_bytes")
        section["observed_high_water_bytes"] = stats.get(
            "observed_high_water_bytes")
        # per-run dominant attribution over the probe's own recorder:
        # every timeline is retained (baseline_ratio=1.0), so this is
        # the full measured population, not an anomaly sample
        dominant: Dict[str, int] = {}
        for timeline in recorder.retained():
            if timeline.seq in warm_seqs:
                continue
            att = timeline.attribution()
            key = att.get("dominant")
            if key:
                dominant[key] = dominant.get(key, 0) + 1
        section["dominant"] = dominant
        stage_rows = section["stage_ms"]
        total_avg = sum(row.get("avg_ms", 0.0)
                        for row in stage_rows.values())
        if stage_rows and total_avg > 0:
            hot = max(stage_rows, key=lambda k: stage_rows[k]["avg_ms"])
            section["hot_stage"] = hot
            section["hot_share"] = round(
                stage_rows[hot]["avg_ms"] / total_avg, 4)
    except InferenceServerException as e:
        section["error"] = str(e)
    finally:
        if client is not None:
            client.close()
    return section


def _registry_section(snapshot: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {name: family for name, family in snapshot.items()
            if name.startswith(prefix) and family.get("series")}


def _anomalies(snap: Dict[str, Any], churn_threshold_ops_s: float,
               skew_warn_ms: float) -> List[Dict[str, Any]]:
    flags: List[Dict[str, Any]] = []
    for ep in snap["endpoints"]:
        url = ep["url"]
        if not ep.get("live") or not ep.get("ready"):
            flags.append({"flag": "endpoint_unhealthy", "url": url,
                          "detail": ep.get("health_error", "not ready")})
        if ep.get("probe_errors"):
            flags.append({"flag": "probe_errors", "url": url,
                          "detail": ep.get("probe_error", "")})
        skew = ep.get("clock_skew_ms")
        if skew is not None:
            slack = ep.get("clock_skew_uncertainty_ms", 0.0)
            if abs(skew) > skew_warn_ms + slack:
                flags.append({"flag": "clock_skew", "url": url,
                              "detail": f"{skew:+.1f} ms (±{slack:.1f})"})
    for url, stats in snap.get("endpoint_stats", {}).items():
        state = stats.get("breaker_state")
        if state and state != "closed":
            flags.append({"flag": "breaker_" + state, "url": url,
                          "detail": f"breaker {state}"})
        if stats.get("ejected"):
            flags.append({"flag": "endpoint_ejected", "url": url,
                          "detail": f"for {stats.get('ejected_for_s', 0)}s"})
        # byzantine replica: this endpoint is RESPONDING — transport is
        # healthy, the breaker sees successes — but what it returns fails
        # contract validation. Health probes will never catch it; only the
        # per-response integrity checks do. quarantined means it is
        # currently ejected FOR wrongness (not latency/errors), which is
        # the strongest possible signal that the replica itself is
        # corrupt: restart or reimage it, don't wait for readmission.
        if stats.get("quarantined"):
            flags.append({
                "flag": "byzantine_replica", "url": url,
                "detail": (f"quarantined after "
                           f"{stats.get('invalid_total', 0)} invalid "
                           f"responses (quarantine #"
                           f"{stats.get('quarantine_count', 0)}) — "
                           "replica answers probes but returns corrupt "
                           "payloads; restart or reimage it")})
        elif stats.get("invalid_total"):
            flags.append({
                "flag": "byzantine_replica", "url": url,
                "detail": (f"{stats['invalid_total']} responses failed "
                           "integrity validation (below the quarantine "
                           "threshold so far) — watch this replica")})
    # a sharded deployment has ZERO failover headroom: every logical
    # request needs EVERY pinned endpoint, so one degraded replica is a
    # whole-deployment outage, not an N-1 brownout — say so explicitly
    for row in (snap.get("shard") or {}).get("shards", []):
        problems = []
        if not row.get("ready"):
            problems.append("not ready")
        if row.get("ejected"):
            problems.append("ejected")
        breaker = row.get("breaker_state")
        if breaker and breaker != "closed":
            problems.append(f"breaker {breaker}")
        if problems:
            flags.append({
                "flag": "shard_degraded", "url": row["url"],
                "detail": (f"shard {row['shard']} pinned endpoint is "
                           f"{', '.join(problems)}; a sharded deployment "
                           "has zero failover headroom — every logical "
                           "request fails (typed ShardFailed) until this "
                           "replica recovers")})
    # disaggregated prefill/decode: a serving role with members but ZERO
    # routable ones means every role-aware session is degrading to the
    # monolithic fallback path — correct but silent capacity loss; the
    # pool's RoleFallback counter is the traffic-is-actually-flowing proof
    for role, row in (snap.get("roles") or {}).items():
        if row.get("endpoints", 0) > 0 and not row.get("available"):
            fallbacks = row.get("fallbacks", 0)
            detail = (f"role {role!r}: 0/{row['endpoints']} endpoints "
                      f"routable — role-aware traffic is falling back to "
                      f"monolithic serving")
            if fallbacks:
                detail += f" ({fallbacks} RoleFallback events counted)"
            flags.append({"flag": "role_degraded", "url": None,
                          "role": role, "detail": detail})
    # client-orchestrated DAG: one stage soaking up most of the graph's
    # wall time is the pipeline's capacity ceiling — replicate THAT
    # model, not the whole chain. Only meaningful with >= 2 stages (a
    # one-stage pipeline trivially dominates itself) and flagged off the
    # probe's own measured waterfall, not a heuristic.
    pipe = snap.get("pipeline") or {}
    hot = pipe.get("hot_stage")
    if (hot is not None and len(pipe.get("stages", [])) >= 2
            and pipe.get("hot_share", 0.0) >= 0.5):
        row = (pipe.get("stage_ms") or {}).get(hot, {})
        flags.append({
            "flag": "pipeline_stage_hot", "url": None, "stage": hot,
            "detail": (f"stage {hot!r} holds "
                       f"{pipe['hot_share']:.0%} of the DAG's stage "
                       f"time (avg {row.get('avg_ms', 0):.2f} ms over "
                       f"{pipe.get('runs', 0)} probe runs) — scale "
                       f"that model's replicas before the rest of the "
                       f"chain")})
    if pipe.get("errors"):
        flags.append({
            "flag": "pipeline_probe_errors", "url": None,
            "detail": (f"{len(pipe['errors'])} of "
                       f"{pipe['runs'] + len(pipe['errors'])} probe DAG "
                       f"runs failed: {pipe['errors'][0]}")})
    for slo in snap.get("slos", []):
        if slo["breached"]:
            flags.append({
                "flag": "slo_breached", "url": None,
                "detail": f"{slo['name']}: burn {slo['burn_rate']:.2f}x"})
    # admission collapse: the adaptive limit is pinned at its floor WHILE
    # an SLO is burning — the limiter has given all it can and latency is
    # still over target, i.e. the fleet is undersized (or a replica is
    # sick), not merely bursty. A floor-pinned limit on a quiet, in-SLO
    # fleet is just the idle state and is never flagged.
    slo_burning = any(s.get("breached") for s in snap.get("slos", []))
    for row in snap.get("admission", []) or []:
        if row.get("collapsed") and slo_burning:
            flags.append({
                "flag": "admission_collapse", "url": None,
                "detail": (f"scope {row.get('scope', 'pool')}: limit "
                           f"{row.get('limit')} pinned at floor "
                           f"{row.get('limiter', {}).get('min_limit')} "
                           f"with an SLO burning "
                           f"(shed_total={row.get('shed_total')})")})
    # multi-cell federation: a SERVING cell with nothing routable (or a
    # cell breaker open) is a whole-site outage in progress — every
    # request that preferred it is spilling or failing; spillover-active
    # means the shed-rate hysteresis is currently steering new traffic
    # past a cell (capacity is degraded even though users see no errors);
    # canary_burning means the canary's SLO burn tripped (or is tripping)
    # — the rollout is bad and the auto-rollback is the only thing
    # between it and the users
    for fedrow in snap.get("cells", []) or []:
        for name, cell in (fedrow.get("cells") or {}).items():
            pool = cell.get("pool") or {}
            breaker = cell.get("breaker_state")
            if cell.get("role") == "serve" and (
                    pool.get("available") is False or breaker == "open"):
                problems = []
                if pool.get("available") is False:
                    problems.append(
                        f"{pool.get('healthy', 0)}/"
                        f"{pool.get('endpoints', '?')} endpoints routable")
                if breaker and breaker != "closed":
                    problems.append(f"cell breaker {breaker}")
                flags.append({
                    "flag": "cell_down", "url": name,
                    "detail": ", ".join(problems) or "cell unavailable"})
            if cell.get("spill_active"):
                flags.append({
                    "flag": "spillover_active", "url": name,
                    "detail": (f"shed rate {cell.get('shed_rate')} over "
                               f"the hysteresis window; spill_out="
                               f"{sum((cell.get('spill_out') or {}).values())}")})
        canary = fedrow.get("canary")
        if canary and (canary.get("breached") or canary.get("rolled_back")):
            state = ("rolled back" if canary.get("rolled_back")
                     else "burning")
            flags.append({
                "flag": "canary_burning", "url": canary.get("cell"),
                "detail": (f"canary {state}: burn "
                           f"{canary.get('burn_rate')}x over "
                           f"{canary.get('ok', 0) + canary.get('bad', 0)} "
                           f"events (weight now "
                           f"{canary.get('weight')})")})
    # cache thrash: the response cache is churning entries out (capacity
    # evictions rival insertions) while barely serving hits — the cache
    # is sized below the workload's working set, so it burns staging work
    # for nothing. A small or cold cache with few lookups never flags.
    for row in snap.get("cache", []) or []:
        if "error" in row:
            continue
        lookups = (row.get("hits", 0) + row.get("stale_hits", 0)
                   + row.get("misses", 0))
        cap_evictions = (row.get("evictions") or {}).get("capacity", 0)
        insertions = row.get("insertions", 0)
        hit_rate = row.get("hit_rate") or 0.0
        if (lookups >= 50 and insertions > 0
                and cap_evictions >= 0.5 * insertions and hit_rate < 0.2):
            flags.append({
                "flag": "cache_thrash", "url": None,
                "detail": (f"{cap_evictions} capacity evictions over "
                           f"{insertions} insertions with hit rate "
                           f"{hit_rate:.0%} — the working set exceeds "
                           f"max_bytes={row.get('max_bytes')}")})
    # noisy neighbor: a tenant's over-quota sheds dwarf what it was
    # admitted — it is offering far beyond its declared rate, and only
    # the tenancy layer (token buckets + weighted-fair queues) stands
    # between its excess and the compliant tenants' capacity. Named per
    # tenant: the verdict comes from the policy's own counters, so it
    # holds even when the neighbors' latencies look healthy (isolation
    # working is not a reason to hide who is being isolated).
    for row in snap.get("tenancy", []) or []:
        if "error" in row:
            continue
        for verdict in row.get("noisy_neighbors", []) or []:
            flags.append({
                "flag": "noisy_neighbor", "url": None,
                "tenant": verdict.get("tenant"),
                "detail": (f"tenant {verdict.get('tenant')!r}: "
                           f"{verdict.get('over_quota_sheds')} over-quota "
                           f"sheds vs {verdict.get('admitted_total')} "
                           f"admitted (offered/admitted ~"
                           f"{verdict.get('offered_over_admitted')}x) — "
                           f"quotas are shedding its excess; compliant "
                           f"tenants keep their weighted share")})
    # affinity skew: one endpoint owns far more than its fair share of
    # the affinity key universe — hot keys are concentrating (a zipfian
    # workload's hottest keys hashed together, or the fleet shrank and
    # re-homing piled keys onto one survivor)
    aff = {url: stats["affinity"]
           for url, stats in snap.get("endpoint_stats", {}).items()
           if stats.get("affinity")}
    if len(aff) >= 2:
        total_keys = sum(a.get("keys", 0) for a in aff.values())
        if total_keys >= 16:
            url, top = max(aff.items(), key=lambda kv: kv[1].get("keys", 0))
            share = top.get("keys", 0) / total_keys
            # twice the fair share, clamped into (0.5, 0.9]: the 0.9 cap
            # keeps the flag reachable on a 2-endpoint pool (where 2x
            # fair share would be an unattainable 100%)
            if share > min(0.9, max(0.5, 2.0 / len(aff))):
                flags.append({
                    "flag": "affinity_skew", "url": url,
                    "detail": (f"owns {share:.0%} of {total_keys} tracked "
                               f"affinity keys across {len(aff)} endpoints "
                               f"(fair share {1.0 / len(aff):.0%})")})
    # tail divergence: the flight recorder's retained slow tail shares one
    # dominant attribution key (a layer, or a layer:endpoint pair) that
    # the baseline traffic does not — the one-bad-replica / one-hot-lock
    # signature, named per-request instead of inferred from aggregates
    divergence = (snap.get("flight") or {}).get("tail_divergence")
    if divergence:
        url = None
        dominant = divergence["dominant"]
        if ":" in dominant:
            url = dominant.split(":", 1)[1]
        flags.append({
            "flag": "tail_divergence", "url": url,
            "detail": (f"{divergence['tail_share']:.0%} of "
                       f"{divergence['tail_count']} retained slow-tail "
                       f"timelines are dominated by {dominant!r} "
                       f"(baseline share "
                       f"{divergence['baseline_share']:.0%})")})
    dataplane = snap.get("shm", {}).get("dataplane")
    if dataplane and churn_threshold_ops_s:
        # prefer the probe-window rate: the lifetime average of a
        # long-quiet process dilutes a burst happening right now
        churn = dataplane.get("churn_ops_per_s_window",
                              dataplane.get("churn_ops_per_s", 0.0))
        if churn > churn_threshold_ops_s:
            flags.append({
                "flag": "shm_churn_high", "url": None,
                "detail": f"{churn:.0f} ops/s > {churn_threshold_ops_s:.0f}"})
    leased = snap.get("shm", {}).get("arena_leased_bytes")
    if leased and leased["after_probe"] > leased["before_probe"]:
        # leased bytes did not return to the pre-probe baseline: some path
        # leased a slab during the probe and never released it
        flags.append({
            "flag": "shm_arena_leak", "url": None,
            "detail": (f"leased bytes {leased['before_probe']} -> "
                       f"{leased['after_probe']} over the probe")})
    # load/latency divergence: an endpoint much slower than the fleet
    # median whose server-side busy signal is NOT above median — the
    # extra milliseconds are outside the server (network, proxy, queueing
    # in front of it). Endpoints with NO server-side signal are never
    # flagged: without one the server cannot be ruled out as the cause.
    rows = [(ep["url"], ep["probe_latency_ms"]["avg"],
             _server_compute_us(snap, ep["url"]))
            for ep in snap["endpoints"] if "probe_latency_ms" in ep]
    if len(rows) >= 2:
        latencies = sorted(lat for _, lat, _ in rows)
        computes = sorted(c for _, _, c in rows if c is not None)
        # LOWER median: with the upper one a 2-endpoint fleet's slower
        # replica IS the median, so `lat > 2*median` could never fire
        median_lat = latencies[(len(latencies) - 1) // 2]
        median_compute = (computes[(len(computes) - 1) // 2]
                          if computes else None)
        for url, lat, compute_us in rows:
            if compute_us is None or median_compute is None:
                continue
            slow = lat > 2.0 * median_lat and lat - median_lat > 1.0
            if not slow:
                continue
            # does the server-side compute excess explain the latency
            # excess? A ratio test on raw compute is noise-prone (tiny
            # models compute in single-digit ms with same-magnitude
            # jitter); the divergence question is whether the EXTRA
            # milliseconds happened inside the server or outside it
            excess_lat_ms = lat - median_lat
            excess_compute_ms = max(compute_us - median_compute, 0.0) / 1e3
            if excess_compute_ms < 0.5 * excess_lat_ms:
                flags.append({
                    "flag": "load_latency_divergence", "url": url,
                    "detail": (f"latency {lat:.1f} ms vs fleet median "
                               f"{median_lat:.1f} ms, server compute "
                               f"explains {excess_compute_ms:.1f} ms of "
                               f"the {excess_lat_ms:.1f} ms excess")})
    # continuous-monitoring verdicts: the watchtower's ACTIVE alerts are
    # incidents in progress, distinct from the point-in-time probe flags
    # above. A changepoint trip is surfaced with the endpoint/layer the
    # flight divergence named (or the fleet-shift verdict) so the
    # snapshot says what moved, not just that something did.
    watch_sec = snap.get("watch") or {}
    for alert in watch_sec.get("active", []) or []:
        kind = alert.get("kind")
        evidence = alert.get("evidence") or {}
        if kind == "changepoint":
            flags.append({
                "flag": "changepoint", "url": None,
                "detail": (f"{alert.get('source')}: moved to "
                           f"{evidence.get('value')} from baseline "
                           f"{evidence.get('baseline_mean')} — "
                           f"{evidence.get('moved', 'fleet_shift')}")})
        else:
            flags.append({
                "flag": "alert_firing", "url": None,
                "detail": (f"{kind}:{alert.get('source')} "
                           f"severity={alert.get('severity')} since "
                           f"{alert.get('fired_unix')}")})
    return flags


def _server_compute_us(snap: Dict[str, Any], url: str) -> Optional[float]:
    """The endpoint's server-side busy signal: the decomposition's
    per-request server compute measured over the probe window, falling
    back to the ORCA-reported average. The window-scoped number comes
    first — ORCA's ``avg_compute_infer_us`` is a lifetime average, so
    one-time history (jit compile, warmup) can read as "busy" long after
    the endpoint went idle and mask a divergence happening now."""
    rows = [r for r in snap.get("decomposition", []) if r["url"] == url]
    if rows:
        return max(r["server_compute_ms"] for r in rows) * 1e3
    load = snap.get("endpoint_stats", {}).get(url, {}).get("load")
    if load:
        us = load["metrics"].get("named_metrics.avg_compute_infer_us")
        if us is not None:
            return us
    return None


def collect_snapshot(
    urls: Sequence[str],
    protocol: str = "http",
    model: str = "simple",
    requests_per_endpoint: int = 8,
    orca_format: Optional[str] = "json",
    telemetry: Optional[Telemetry] = None,
    churn_threshold_ops_s: float = 10000.0,
    skew_warn_ms: float = 250.0,
    probe_timeout_s: float = 10.0,
    client_factory: Optional[Callable[[str], Any]] = None,
    shard_layout=None,
    cells=None,
    roles=None,
    pipeline=None,
    pipeline_runs: int = 4,
    integrity: bool = False,
    watch: Optional[float] = None,
) -> Dict[str, Any]:
    """Probe the fleet and return the full snapshot dict (JSON-ready).

    ``orca_format`` configures the Telemetry the doctor builds for the
    probe; when a caller-supplied ``telemetry`` is passed it is used as
    is — its own ``orca_format`` (possibly None) wins, since mutating
    the caller's live telemetry mid-scrape would be worse than
    honoring its configuration.

    ``shard_layout``: a ``client_tpu_torch.shard.ShardLayout`` (or its spec
    string, resolved over ``urls`` in order) describing a sharded
    deployment — adds a ``shard`` topology section and flags
    ``shard_degraded`` when any pinned endpoint is unhealthy, ejected or
    breaker-open.

    ``cells``: a ``{name: [urls]}`` dict (or its spec string,
    ``"a=u1+u2;b=u3"``) describing a multi-cell federation
    (``client_tpu_torch.federation``): the doctor stands up a probe
    ``FederatedClient`` over the cells, direct-probes every cell's
    endpoints, and the snapshot gains a ``cells`` section (per-cell
    health, breaker state, spill/shadow/canary counters, SLO burn) plus
    the ``cell_down``/``spillover_active``/``canary_burning`` anomaly
    flags. With an empty ``urls``, the per-endpoint probe section covers
    the cells' urls. A caller-supplied ``telemetry`` that already has an
    application federation attached surfaces it in the same section —
    its LIVE spill counters, not the probe's.

    ``roles``: a ``{role: [urls]}`` dict (or its spec string,
    ``"prefill=u1+u2;decode=u3"``) labeling endpoints with serving
    roles (``client_tpu_torch.disagg``): the probe pool is built with
    role-labeled ``EndpointSpec``s, the snapshot gains a ``roles``
    section (per-role endpoint/healthy counts, availability, counted
    RoleFallback events), and ``role_degraded`` is flagged for any role
    with members but zero routable ones — the state in which every
    role-aware session silently degrades to monolithic serving. With an
    empty ``urls``, the probe covers the roles' urls.

    ``pipeline``: a ``client_tpu_torch.pipeline.Pipeline`` (or its spec
    string: ``"chain"`` or an inline graph spec) declaring a client-
    orchestrated model DAG: the doctor runs it ``pipeline_runs`` times
    through a flight-armed probe ``PipelineClient`` over the fleet and
    the snapshot gains a ``pipeline`` section (per-stage latency
    waterfall, each run's dominant flight attribution, slab-plan vs
    observed arena high-water) plus the ``pipeline_stage_hot`` anomaly
    when one stage dominates the DAG's wall time."""
    if isinstance(cells, str):
        from .federation import parse_cells_spec

        cells = parse_cells_spec(cells)
    if isinstance(roles, str):
        # same "name=u1+u2;name2=u3" grammar as --cells
        from .federation import parse_cells_spec

        roles = parse_cells_spec(roles)
    urls = list(urls)
    if cells and not urls:
        urls = [u for cell_urls in cells.values() for u in cell_urls]
    if roles and not urls:
        urls = [u for role_urls in roles.values() for u in role_urls]
    role_by_url: Dict[str, str] = {}
    for role, role_urls in (roles or {}).items():
        for u in role_urls:
            role_by_url[u] = role
    if isinstance(shard_layout, str):
        from .shard import ShardLayout

        shard_layout = ShardLayout.parse(shard_layout, list(urls))
    if isinstance(pipeline, str):
        from .pipeline import resolve_pipeline

        pipeline = resolve_pipeline(pipeline)
    tel = telemetry
    if tel is None:
        tel = Telemetry(sample="always", orca_format=orca_format,
                        trace_capacity=max(
                            1024, requests_per_endpoint * len(urls) * 2))
    recorder = observe.dataplane()
    scoped_recorder = recorder is None
    if scoped_recorder:
        # CLI runs (and hosts that never enabled accounting) still get a
        # populated data-plane section and a live churn window — counting
        # THIS process's shm ops (zero unless this process touches shm)
        # rather than silently reporting None. With a caller-supplied
        # Telemetry the recorder gets its own registry: probe-scoped shm
        # instruments must not render frozen on the caller's long-lived
        # scrape after the recorder is uninstalled below
        recorder = observe.enable_dataplane(
            tel.registry if telemetry is None else None)
    mod = _input_module(protocol)
    if client_factory is None:
        client_factory = _bounded_client_factory(protocol, probe_timeout_s)
    fed = None
    pool_urls = [EndpointSpec(u, role=role_by_url.get(u)) for u in urls]
    pool = PoolClient(pool_urls, protocol=protocol, telemetry=tel,
                      health_interval_s=None,
                      client_factory=client_factory)
    try:
        if cells:
            from .federation import FederatedClient

            # a probe federation: attaches itself to ``tel`` so the
            # cells section below reads it like any application
            # federation; every transport call is bounded by the probe
            # factory/timeouts
            fed = FederatedClient(
                cells, protocol=protocol, telemetry=tel,
                pool_kwargs={"health_interval_s": None,
                             "client_factory": client_factory})
        correlator = StatsCorrelator(tel, pool,
                                     call_timeout_s=probe_timeout_s)
        correlator.poll_once()  # baseline for the decomposition deltas
        dataplane_before = (recorder.snapshot()
                            if recorder is not None else None)
        arena_leased_before = _arena_leased_bytes()
        probe_t0 = time.monotonic()
        endpoints = []
        for ep in pool.pool.endpoints:
            report = _probe_endpoint(
                ep, mod, model, requests_per_endpoint, probe_timeout_s)
            # feed the manual probe verdict into the engine so
            # endpoint_stats reflects what the doctor just observed
            pool.pool.set_health(ep, report.get("ready", False))
            endpoints.append(report)
        if fed is not None:
            # direct-probe every cell's endpoints so the cells section
            # reflects what is routable RIGHT NOW, not construction-time
            # optimism (wait_healthy probes each endpoint once and feeds
            # pool.set_health — bounded by probe_timeout_s per call)
            fed.wait_healthy(timeout_s=probe_timeout_s)
        correlator.poll_once()
        tel.flush()
        registry_snapshot = tel.registry.snapshot()
        snap: Dict[str, Any] = {
            "generated_unix": int(time.time()),
            "urls": list(urls),
            "protocol": protocol,
            "model": model,
            "endpoints": endpoints,
            "endpoint_stats": pool.endpoint_stats(),
            # per-endpoint probe averages: the network+client remainder
            # is attributed to the endpoint that paid it, not a fleet mean
            "decomposition": correlator.decomposition(client_ms_by_url={
                ep["url"]: ep["probe_latency_ms"]["avg"]
                for ep in endpoints if "probe_latency_ms" in ep}),
            "slos": _slo_status(tel),
            "admission": _admission_status(tel),
            "cells": _federation_status(tel),
            "stream_windows": _registry_section(
                registry_snapshot, "client_tpu_stream_window"),
            "batch": _registry_section(
                registry_snapshot, "client_tpu_batch"),
            "cache": _cache_status(),
            "tenancy": _tenancy_status(),
            "flight": _flight_status(tel),
            "shm": _local_shm(recorder),
        }
        server_shm: Dict[str, Any] = {}
        for ep in pool.pool.endpoints:
            server_shm[ep.url] = _server_shm_status(ep.client,
                                                    probe_timeout_s)
        if shard_layout is not None:
            snap["shard"] = _shard_section(shard_layout, snap)
        if pipeline is not None:
            snap["pipeline"] = _pipeline_section(
                pipeline, urls, protocol, client_factory,
                probe_timeout_s, pipeline_runs)
        role_summary = pool.health_summary().get("roles")
        if role_summary:
            snap["roles"] = role_summary
        snap["shm"]["server_regions"] = server_shm
        dp = snap["shm"]["dataplane"]
        if dp is not None and dataplane_before is not None:
            # churn over the probe window, not the recorder's lifetime: a
            # long-quiet process must still flag a burst happening NOW
            window_s = max(time.monotonic() - probe_t0, 1e-9)
            dp["churn_ops_per_s_window"] = round(
                max(_total_dataplane_ops(dp)
                    - _total_dataplane_ops(dataplane_before), 0.0)
                / window_s, 3)
        # arena leak check: leased bytes must return to the pre-probe
        # baseline once the probe's requests have settled — growth means
        # some path leased without releasing. Application traffic on other
        # threads holds transient leases mid-infer, so a raised reading is
        # re-sampled after short settles and only the settled value is
        # compared (false flags would make the anomaly untrustworthy).
        arena_leased_after = _arena_leased_bytes()
        for _ in range(3):
            if arena_leased_after <= arena_leased_before:
                break
            time.sleep(0.2)
            arena_leased_after = _arena_leased_bytes()
        snap["shm"]["arena_leased_bytes"] = {
            "before_probe": arena_leased_before,
            "after_probe": arena_leased_after,
        }
        # response-integrity section: the process-wide validation
        # counters (every contract-checked response in THIS process, not
        # just the probe's own requests) next to the per-endpoint
        # quarantine view the anomaly pass reads. The overhead
        # percentiles answer "what does always-on validation cost" with
        # measured ns, not an estimate.
        if integrity:
            from . import integrity as _integrity_mod
            snap["integrity"] = _integrity_mod.global_stats().snapshot()
        # continuous-monitoring section: --watch SECONDS runs a live
        # fast-tick watchtower over the probe telemetry (burn + watermark
        # + changepoint rules all armed); without it, a process-global
        # watchtower (enable_watchtower) is snapshotted if installed
        watch_section = _watch_status(tel, watch)
        if watch_section is not None:
            snap["watch"] = watch_section
        snap["anomalies"] = _anomalies(
            snap, churn_threshold_ops_s, skew_warn_ms)
        return snap
    finally:
        pool.close()
        if fed is not None:
            fed.close()
        if scoped_recorder:
            observe.install_dataplane(None)


def _watch_status(tel: Telemetry, watch_s: Optional[float],
                  ) -> Optional[Dict[str, Any]]:
    """The snapshot's ``watch`` section. ``watch_s`` > 0 arms a scoped
    fast-tick watchtower on the probe telemetry for that long (live
    mode); otherwise the process-global watchtower is snapshotted if one
    is installed, and the section is omitted entirely if not."""
    from . import watch as watch_mod

    if watch_s is not None and watch_s > 0:
        tower = watch_mod.Watchtower(
            tel, interval_s=max(float(watch_s) / 20.0, 0.05))
        try:
            deadline = time.monotonic() + float(watch_s)
            while True:
                tower.tick()
                if time.monotonic() >= deadline:
                    break
                time.sleep(tower.interval_s)
            return tower.snapshot()
        finally:
            tower.stop()
    tower = watch_mod.watchtower()
    return tower.snapshot() if tower is not None else None


# every section the bundle PROMOTES to its top level when the snapshot
# carries it — the completeness contract tests pin the bundle to: a new
# snapshot section must be added here (and to the docs) or the
# completeness test fails, so the bundle can't silently go stale again
POSTMORTEM_SECTIONS = ("tenancy", "roles", "integrity", "pipeline",
                       "shard", "cells", "watch")


def postmortem_bundle(snapshot: Dict[str, Any],
                      telemetry: Optional[Telemetry] = None,
                      ) -> Dict[str, Any]:
    """Package one fleet snapshot into a self-contained, JSON-pure
    postmortem artifact: the snapshot (endpoint/admission/cache/arena
    state + anomaly flags), the flight recorder's FULL retained
    timelines (the snapshot carries only summaries), the telemetry's
    metrics snapshot and the SLO report. One file answers "what was the
    fleet doing, and why were the slow requests slow" without a live
    process to interrogate — write it the moment the incident happens,
    not after the evidence has aged out of the rings.

    ``sections`` is the completeness manifest: every key the snapshot
    carries, verbatim — a reader (or the completeness test) checks it
    against the snapshot instead of trusting the bundle's age. The
    :data:`POSTMORTEM_SECTIONS` present in the snapshot (tenancy, roles,
    integrity, pipeline, shard, cells, watch) are additionally promoted
    to the bundle's top level for direct access, and a live
    process-global watchtower contributes its alert state as ``watch``
    even when the snapshot predates it."""
    bundle: Dict[str, Any] = {
        "kind": "client_tpu_postmortem",
        "version": 2,
        "generated_unix": int(time.time()),
        "snapshot": snapshot,
        "sections": sorted(snapshot.keys()),
    }
    for section in POSTMORTEM_SECTIONS:
        if section in snapshot:
            bundle[section] = snapshot[section]
    if "watch" not in bundle:
        from . import watch as watch_mod

        tower = watch_mod.watchtower()
        if tower is not None:
            bundle["watch"] = tower.snapshot()
    recorder = getattr(telemetry, "flight", None) \
        if telemetry is not None else None
    if recorder is not None:
        bundle["flight"] = {
            "stats": recorder.stats(),
            "tail_divergence": recorder.tail_divergence(),
            "timelines": [t.as_dict() for t in recorder.retained()],
        }
    if telemetry is not None:
        bundle["metrics"] = telemetry.registry.snapshot()
        bundle["slo_report"] = telemetry.slo_report()
    return bundle


def render_summary(snap: Dict[str, Any]) -> str:
    """The human-readable side of the snapshot."""
    lines: List[str] = []
    lines.append(f"client_tpu doctor — {len(snap['urls'])} endpoint(s), "
                 f"protocol {snap['protocol']}, model {snap['model']}")
    lines.append("")
    lines.append("endpoints:")
    for ep in snap["endpoints"]:
        state = ("ready" if ep.get("ready")
                 else ("live" if ep.get("live") else "DOWN"))
        row = f"  {ep['url']:<24} {state:<6}"
        lat = ep.get("probe_latency_ms")
        if lat:
            row += f" probe p50 {lat['p50']:.2f} ms (avg {lat['avg']:.2f})"
        skew = ep.get("clock_skew_ms")
        if skew is not None:
            row += f"  skew {skew:+.1f} ms"
        stats = snap.get("endpoint_stats", {}).get(ep["url"], {})
        breaker = stats.get("breaker_state")
        if breaker and breaker != "closed":
            row += f"  breaker={breaker}"
        load = stats.get("load")
        if load:
            busy = load["metrics"].get("named_metrics.avg_compute_infer_us")
            if busy is not None:
                row += f"  orca compute {busy / 1e3:.2f} ms"
        lines.append(row)
    rows = snap.get("decomposition") or []
    if rows:
        lines.append("")
        lines.append("latency decomposition (per request over the probe "
                     "window):")
        for row in rows:
            parts = [f"  {row['url']:<24} {row['model']:<18}"
                     f" n={row['requests']:<4}"
                     f" queue {row['server_queue_ms']:.2f} ms"
                     f" compute {row['server_compute_ms']:.2f} ms"]
            if "network_client_overhead_ms" in row:
                parts.append(
                    f" network+client {row['network_client_overhead_ms']:.2f}"
                    f" ms (client total {row['client_request_ms']:.2f} ms)")
            lines.append("".join(parts))
    shard = snap.get("shard")
    if shard:
        lines.append("")
        layout = shard.get("layout", {})
        lines.append(
            f"shard topology ({layout.get('shards')} shards; inputs "
            f"{layout.get('inputs')} -> outputs {layout.get('outputs')}):")
        for row in shard.get("shards", []):
            state = "ready" if row.get("ready") else "DEGRADED"
            extra = []
            if row.get("ejected"):
                extra.append("ejected")
            breaker = row.get("breaker_state")
            if breaker and breaker != "closed":
                extra.append(f"breaker={breaker}")
            lines.append(
                f"  shard {row['shard']}: {row['url']:<24} {state}"
                f"{('  ' + ' '.join(extra)) if extra else ''}")
    roles = snap.get("roles")
    if roles:
        lines.append("")
        lines.append("roles (disaggregated prefill/decode):")
        for role, row in roles.items():
            state = "available" if row.get("available") else "DEGRADED"
            extra = ""
            if row.get("fallbacks"):
                extra = f"  fallbacks={row['fallbacks']}"
            lines.append(
                f"  {role:<10} {state:<10} healthy "
                f"{row.get('healthy', '?')}/{row.get('endpoints', '?')}"
                f"{extra}")
    pipe = snap.get("pipeline")
    if pipe:
        lines.append("")
        if "error" in pipe:
            lines.append(f"pipeline ({pipe.get('pipeline')}): "
                         f"{pipe['error']}")
        else:
            lines.append(
                f"pipeline ({pipe['pipeline']}; "
                f"{len(pipe.get('stages', []))} stages, "
                f"{pipe.get('runs', 0)} probe runs):")
            stage_ms = pipe.get("stage_ms") or {}
            dominant = pipe.get("dominant") or {}
            for sname in pipe.get("stages", []):
                row = stage_ms.get(sname) or {}
                hot = " HOT" if sname == pipe.get("hot_stage") and (
                    pipe.get("hot_share", 0.0) >= 0.5) else ""
                dom = dominant.get(f"pipeline:{sname}", 0)
                lines.append(
                    f"  {sname:<16} avg {row.get('avg_ms', 0):.2f} ms "
                    f"p50 {row.get('p50_ms', 0):.2f} ms max "
                    f"{row.get('max_ms', 0):.2f} ms  dominant in "
                    f"{dom}/{pipe.get('runs', 0)} runs{hot}")
            lines.append(
                f"  arena high-water: plan "
                f"{pipe.get('plan_high_water_bytes')}B observed "
                f"{pipe.get('observed_high_water_bytes')}B")
    for fedrow in snap.get("cells") or []:
        if "error" in fedrow:
            lines.append("")
            lines.append(f"cells ({fedrow.get('scope')}): {fedrow['error']}")
            continue
        lines.append("")
        lines.append(
            f"cells ({fedrow.get('scope', 'federation')}; home "
            f"{fedrow.get('home')}, order "
            f"{'->'.join(fedrow.get('order', []))}):")
        for name, cell in (fedrow.get("cells") or {}).items():
            pool_row = cell.get("pool") or {}
            state = ("UP" if pool_row.get("available")
                     else ("DOWN" if pool_row else "?"))
            extra = []
            breaker = cell.get("breaker_state")
            if breaker and breaker != "closed":
                extra.append(f"breaker={breaker}")
            if cell.get("spill_active"):
                extra.append(f"SPILLING (shed {cell.get('shed_rate')})")
            spills = sum((cell.get("spill_out") or {}).values())
            lines.append(
                f"  {name:<10} {cell.get('role', 'serve'):<7} {state:<5}"
                f" healthy {pool_row.get('healthy', '?')}/"
                f"{pool_row.get('endpoints', '?')}"
                f"  served={cell.get('served', 0)}"
                f" spill_out={spills} spill_in={cell.get('spill_in', 0)}"
                f"{('  ' + ' '.join(extra)) if extra else ''}")
        shadow = fedrow.get("shadow")
        if shadow:
            lines.append(
                f"  shadow -> {shadow['cell']} ratio={shadow['ratio']:g} "
                f"sent={shadow['sent']} matched={shadow['matched']} "
                f"diverged={shadow['diverged']} errors={shadow['errors']} "
                f"skipped={shadow['skipped']}")
        canary = fedrow.get("canary")
        if canary:
            state = ("ROLLED BACK" if canary.get("rolled_back")
                     else ("BURNING" if canary.get("breached") else "ok"))
            lines.append(
                f"  canary -> {canary['cell']} weight="
                f"{canary.get('weight'):g} "
                f"(declared {canary.get('declared_weight'):g}) "
                f"routed={canary.get('routed', 0)} "
                f"ok={canary.get('ok', 0)} bad={canary.get('bad', 0)} "
                f"burn={canary.get('burn_rate')}x  {state}")
    admission = snap.get("admission") or []
    if admission:
        lines.append("")
        lines.append("admission:")
        for row in admission:
            if "error" in row:
                lines.append(f"  {row.get('scope', 'pool')}: {row['error']}")
                continue
            sheds = sum(
                n for lane in row.get("lanes", {}).values()
                for n in lane.get("shed", {}).values())
            lines.append(
                f"  {row.get('scope', 'pool'):<8} limit={row['limit']} "
                f"inflight={row['inflight']} "
                f"admitted={row['admitted_total']} shed={sheds}"
                f"{'  COLLAPSED' if row.get('collapsed') else ''}")
    slos = snap.get("slos") or []
    if slos:
        lines.append("")
        lines.append("slos:")
        for slo in slos:
            verdict = "BREACHED" if slo["breached"] else "ok"
            lines.append(
                f"  {slo['name']:<20} {slo['metric']} < "
                f"{slo['threshold_ms']:g} ms @ {slo['objective']:.0%}"
                f"  burn {slo['burn_rate']:.2f}x  {verdict}")
    cache_rows = snap.get("cache") or []
    if cache_rows:
        lines.append("")
        lines.append("response cache:")
        for row in cache_rows:
            if "error" in row:
                lines.append(f"  cache: {row['error']}")
                continue
            hit_rate = row.get("hit_rate")
            ev = row.get("evictions") or {}
            lines.append(
                f"  entries={row.get('entries')} "
                f"resident={row.get('bytes_resident')}B "
                f"hit_rate={'n/a' if hit_rate is None else f'{hit_rate:.0%}'} "
                f"evictions={sum(ev.values())} "
                f"(capacity={ev.get('capacity', 0)} ttl={ev.get('ttl', 0)})")
    tenancy_rows = snap.get("tenancy") or []
    if tenancy_rows:
        lines.append("")
        lines.append("tenancy:")
        for row in tenancy_rows:
            if "error" in row:
                lines.append(f"  tenancy: {row['error']}")
                continue
            for label, t in sorted((row.get("tenants") or {}).items()):
                window = t.get("window") or {}
                sheds = sum((t.get("shed") or {}).values())
                tokens = t.get("quota_tokens")
                burn = window.get("burn_rate")
                lines.append(
                    f"  {label:<16} admitted={t.get('admitted_total', 0)} "
                    f"shed={sheds} "
                    f"tokens={'n/a' if tokens is None else f'{tokens:.1f}'} "
                    f"burn={'n/a' if burn is None else f'{burn:.2f}x'}"
                    f"{'  BREACHED' if window.get('breached') else ''}")
    aff_stats = {url: s["affinity"]
                 for url, s in snap.get("endpoint_stats", {}).items()
                 if s.get("affinity")}
    if aff_stats:
        lines.append("")
        lines.append("affinity routing:")
        for url, a in aff_stats.items():
            lines.append(
                f"  {url:<24} routed={a.get('routed', 0)} "
                f"rehomed={a.get('rehomed', 0)} "
                f"spilled={a.get('spilled', 0)} keys={a.get('keys', 0)}")
    shm = snap.get("shm", {})
    dataplane = shm.get("dataplane")
    if dataplane:
        lines.append("")
        lines.append("data plane (this process):")
        for family, row in dataplane.get("families", {}).items():
            if not any(row.values()):
                continue
            lines.append(
                f"  {family:<7} regions={row['regions']:.0f} "
                f"resident={row['bytes_resident']:.0f}B "
                f"peak={row['bytes_peak']:.0f}B "
                f"created={row['created']:.0f} "
                f"destroyed={row['destroyed']:.0f}")
        lines.append(
            f"  churn {dataplane.get('churn_ops_per_s', 0):.1f} ops/s")
    for row in shm.get("arena") or []:
        stats = row.get("stats")
        if not stats:
            continue
        hit_rate = stats.get("hit_rate")
        cache = row.get("registration_cache") or {}
        lines.append(
            f"  arena  regions={stats['regions']} "
            f"leased={stats['leased_bytes']}B free={stats['free_bytes']}B "
            f"hit_rate={'n/a' if hit_rate is None else f'{hit_rate:.0%}'} "
            f"reg_cache={sum(len(v) for v in cache.values())} entries"
            f"/{len(cache)} endpoints")
    inventory = shm.get("local_inventory") or []
    if inventory:
        lines.append(f"  local regions: "
                     f"{', '.join(r['name'] for r in inventory)}")
    fl = snap.get("flight")
    if fl:
        stats = fl["stats"]
        lines.append("")
        lines.append(
            f"flight recorder: {stats['retained_total']} retained of "
            f"{stats['requests']} requests "
            f"(ring {stats['ring']}/{stats['capacity']}, "
            f"dropped {stats['dropped']})")
        for row in fl.get("last_anomalies", [])[:4]:
            lines.append(
                f"  {row['verdict']:<10} {row['model']:<16} "
                f"{row['duration_ms']:.1f} ms  dominant="
                f"{row['dominant']}  trace={row['trace_id']}")
    integ = snap.get("integrity")
    if integ:
        lines.append("")
        oh = integ.get("overhead_ns") or {}
        lines.append(
            f"integrity: {integ['results']} results validated, "
            f"{integ['checks']} checks, {integ['violations']} violations"
            + (f"  overhead p50={oh['p50'] / 1e3:.1f}us "
               f"p99={oh['p99'] / 1e3:.1f}us"
               if oh.get("samples") else ""))
        for kind, n in sorted((integ.get("violations_by_kind")
                               or {}).items()):
            lines.append(f"  violation kind {kind}: {n}")
        for url, n in sorted((integ.get("violations_by_url")
                              or {}).items()):
            lines.append(f"  violating url {url}: {n}")
    watch_sec = snap.get("watch")
    if watch_sec:
        lines.append("")
        tick = watch_sec.get("tick_ns") or {}
        lines.append(
            f"watch: {watch_sec.get('ticks', 0)} ticks, "
            f"{watch_sec.get('alerts_fired_total', 0)} alerts fired / "
            f"{watch_sec.get('alerts_resolved_total', 0)} resolved, "
            f"{watch_sec.get('changepoint_trips', 0)} changepoint trips"
            + (f"  (tick p50={tick['p50'] / 1e3:.1f}us "
               f"p99={tick['p99'] / 1e3:.1f}us)" if tick else ""))
        for alert in watch_sec.get("active", []) or []:
            ev = alert.get("evidence") or {}
            moved = ev.get("moved") or ev.get("divergence", {})
            lines.append(
                f"  FIRING {alert.get('kind')}:{alert.get('source')} "
                f"severity={alert.get('severity')}"
                + (f"  moved={moved}" if moved else ""))
        for row in (watch_sec.get("recent") or [])[-4:]:
            if row.get("state") == "resolved":
                lines.append(
                    f"  resolved {row.get('kind')}:{row.get('source')} "
                    f"after "
                    f"{(row.get('resolved_unix') or 0) - (row.get('fired_unix') or 0):.1f}s")
    anomalies = snap.get("anomalies") or []
    lines.append("")
    if anomalies:
        lines.append(f"ANOMALIES ({len(anomalies)}):")
        for flag in anomalies:
            where = f" [{flag['url']}]" if flag.get("url") else ""
            lines.append(f"  !! {flag['flag']}{where}: {flag['detail']}")
    else:
        lines.append("no anomalies detected")
    return "\n".join(lines)


def _render_blackbox(doc: Dict[str, Any]) -> str:
    """Human-readable rendering of a :func:`watch.blackbox_report`
    reconstruction — what the operator reads after the kill -9."""
    lines = [f"client_tpu blackbox reconstruction — {doc['path']}"]
    if not doc.get("ok"):
        lines.append(f"  UNREADABLE: {doc.get('note')}")
        return "\n".join(lines)
    scan = doc.get("scan") or {}
    lines.append(
        f"  {doc.get('records', 0)} records verified "
        f"({scan.get('rejected', 0)} rejected by checksum/format) from a "
        f"{scan.get('capacity_bytes', 0)}B ring")
    meta = doc.get("meta")
    if meta:
        lines.append(f"  writer: pid={meta.get('pid')} "
                     f"started_unix={meta.get('started_unix')} "
                     f"interval={meta.get('interval_s')}s")
    lines.append(
        f"  flight timelines recovered: {doc.get('timelines_recovered', 0)}"
        f" (showing last {len(doc.get('timelines') or [])})")
    for tl in (doc.get("timelines") or [])[-6:]:
        lines.append(
            f"    {tl.get('verdict', '?'):<10} {tl.get('model', ''):<16} "
            f"{tl.get('duration_ms', 0):.1f} ms  "
            f"dominant={(tl.get('attribution') or {}).get('dominant')}")
    metrics = doc.get("metrics")
    lines.append(
        f"  metrics snapshots recovered: "
        f"{doc.get('metrics_snapshots_recovered', 0)}"
        + (f" (last carries {len(metrics)} families)" if metrics else ""))
    alerts = doc.get("alerts") or []
    lines.append(f"  alerts recovered: {len(alerts)}")
    for alert in alerts[-6:]:
        lines.append(
            f"    {alert.get('state', '?'):<9} "
            f"{alert.get('kind')}:{alert.get('source')} "
            f"severity={alert.get('severity')} "
            f"fired_unix={alert.get('fired_unix')}")
    last = doc.get("last_alert")
    if last:
        lines.append(
            f"  last alert: {last.get('kind')}:{last.get('source')} "
            f"({last.get('state')})")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.doctor",
        description="One-command fleet snapshot for a client_tpu "
                    "deployment (health, breakers, ORCA load, latency "
                    "decomposition, shm inventory, anomalies).")
    parser.add_argument("urls", nargs="*", default=[],
                        help="replica host:port urls (optional when "
                             "--cells is given: the cells' urls are "
                             "probed)")
    parser.add_argument("--protocol", choices=("http", "grpc"),
                        default="http")
    parser.add_argument("--model", default="simple",
                        help="model to probe (inputs synthesized from its "
                             "metadata)")
    parser.add_argument("--requests", type=int, default=8,
                        help="probe infers per endpoint")
    parser.add_argument("--orca", choices=("json", "text"), default="json",
                        help="ORCA endpoint-load-metrics format to request")
    parser.add_argument("--churn-threshold", type=float, default=10000.0,
                        help="shm churn ops/s above which to flag")
    parser.add_argument("--skew-warn-ms", type=float, default=250.0)
    parser.add_argument("--shard-layout", default=None,
                        help="sharded-deployment layout spec over the "
                             "given urls in shard order, e.g. "
                             "'TOKENS=0->LOGITS=0,NEXT_TOKEN=0': adds the "
                             "shard topology section and the "
                             "shard_degraded anomaly (client_tpu_torch.shard)")
    parser.add_argument("--cells", default=None, metavar="SPEC",
                        help="multi-cell federated snapshot: "
                             "'a=u1+u2;b=u3' stands up a probe "
                             "FederatedClient over the named cells and "
                             "adds the per-cell section (health, breaker, "
                             "spill/shadow/canary counters, SLO burn) "
                             "plus the cell_down/spillover_active/"
                             "canary_burning anomaly flags "
                             "(client_tpu_torch.federation)")
    parser.add_argument("--roles", default=None, metavar="SPEC",
                        help="role-labeled snapshot for a disaggregated "
                             "prefill/decode fleet: "
                             "'prefill=u1+u2;decode=u3' labels the probe "
                             "pool's endpoints, adds the per-role section "
                             "(healthy counts, availability, RoleFallback "
                             "events) and flags role_degraded for any "
                             "role with zero routable members "
                             "(client_tpu_torch.disagg)")
    parser.add_argument("--pipeline", default=None, metavar="SPEC",
                        help="client-orchestrated model-DAG probe: "
                             "'chain' (the zoo's tokenize->embed->rerank "
                             "chain) or an inline graph spec runs the "
                             "DAG through a flight-armed PipelineClient "
                             "over the fleet, adds the pipeline section "
                             "(per-stage waterfall, dominant flight "
                             "attribution, slab-plan vs observed arena "
                             "high-water) and flags pipeline_stage_hot "
                             "when one stage dominates "
                             "(client_tpu_torch.pipeline)")
    parser.add_argument("--pipeline-runs", type=int, default=4,
                        help="probe DAG executions for --pipeline")
    parser.add_argument("--integrity", action="store_true",
                        help="add the response-integrity section: the "
                             "process-wide contract-validation counters "
                             "(results checked, violations by kind and "
                             "by url, measured per-response overhead "
                             "p50/p99) from client_tpu_torch.integrity; "
                             "byzantine_replica anomalies are always "
                             "flagged off endpoint quarantine state, "
                             "with or without this flag")
    parser.add_argument("--timeout", type=float, default=10.0,
                        help="per-call timeout (s) bounding every snapshot "
                             "RPC: health probes, probe infers, stats "
                             "polls, metadata and shm-status calls")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="also write the snapshot JSON artifact here")
    parser.add_argument("--postmortem", dest="postmortem_path",
                        default=None, metavar="PATH",
                        help="write a self-contained postmortem bundle "
                             "(snapshot + metrics + SLO report + the "
                             "flight recorder's full retained timelines; "
                             "arms a flight recorder on the probe "
                             "telemetry)")
    parser.add_argument("--watch", type=float, default=None,
                        metavar="SECONDS",
                        help="live continuous-monitoring mode: arm a "
                             "fast-tick Watchtower (burn-rate, watermark "
                             "and changepoint rules) over the probe "
                             "telemetry for SECONDS, and add the watch "
                             "section (active alerts, detector states, "
                             "tick overhead) plus the alert_firing/"
                             "changepoint anomalies (client_tpu_torch.watch)")
    parser.add_argument("--blackbox", dest="blackbox_path", default=None,
                        metavar="PATH",
                        help="read a crash-safe black-box ring file "
                             "(client_tpu_torch.watch.BlackBox) instead of "
                             "probing a fleet: reconstructs the retained "
                             "flight timelines, the last metrics "
                             "snapshot and the alert history from the "
                             "ring alone — works after a kill -9, needs "
                             "no live process; torn records are skipped, "
                             "never fatal")
    parser.add_argument("--fail-on-anomaly", action="store_true",
                        help="exit 1 when any anomaly is flagged")
    args = parser.parse_args(argv)
    if args.blackbox_path:
        from . import watch as watch_mod

        doc = watch_mod.blackbox_report(args.blackbox_path)
        print(_render_blackbox(doc))
        if args.json_path:
            with open(args.json_path, "w") as f:
                json.dump(doc, f, indent=2, default=str)
            print(f"\nblackbox report written to {args.json_path}")
        return 0 if doc["ok"] else 1
    if not args.urls and not args.cells and not args.roles:
        parser.error("give replica urls, --cells 'a=u1+u2;b=u3', "
                     "--roles 'prefill=u1;decode=u2', or --blackbox PATH")

    tel = None
    if args.postmortem_path:
        # a flight-armed probe telemetry: the probe requests themselves
        # are recorded, so even a cold process's bundle carries per-
        # request evidence about the fleet it just touched
        tel = Telemetry(sample="always", orca_format=args.orca,
                        flight=True)
    snap = collect_snapshot(
        args.urls, protocol=args.protocol, model=args.model,
        requests_per_endpoint=args.requests, orca_format=args.orca,
        telemetry=tel,
        churn_threshold_ops_s=args.churn_threshold,
        skew_warn_ms=args.skew_warn_ms, probe_timeout_s=args.timeout,
        shard_layout=args.shard_layout, cells=args.cells,
        roles=args.roles, pipeline=args.pipeline,
        pipeline_runs=args.pipeline_runs, integrity=args.integrity,
        watch=args.watch)
    print(render_summary(snap))
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(snap, f, indent=2, default=str)
        print(f"\nsnapshot written to {args.json_path}")
    if args.postmortem_path:
        bundle = postmortem_bundle(snap, tel)
        with open(args.postmortem_path, "w") as f:
            json.dump(bundle, f, indent=2, default=str)
        print(f"postmortem bundle written to {args.postmortem_path}")
    if args.fail_on_anomaly and snap.get("anomalies"):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
