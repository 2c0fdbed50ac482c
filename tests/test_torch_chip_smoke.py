"""``chip_smoke.py``'s phases 6 (resilience and observability), 7 (the
measurement harness) and 8 (the standalone server in processes of its own)
on the CPU.

Phase 6 serves the default zoo and the vision models behind the port's
``ChaosProxy`` and checks itself: zero errors for the idempotent flows under
faults, a sequence request never re-sent, one ``StreamReconnected`` naming
the abandoned sequence id, the breaker's transitions, the flight recorder's
retained failures, every span joined to a server access record, ``/metrics``
equal to the statistics and the data-plane counters equal to the ops made.
On a CPU device the kernel wrappers run their plain versions and launch
nothing, so its launch gate expects zeros there; the references are a CPU
run of the decoder and of densenet with the seed-0 weights, as on the card.
Phase 8 starts ``client_tpu_torch.serve --device cpu`` in child processes;
phase 9 (the pool, batch, cache and tenancy layers over two servers) runs
against two port servers in this process.
"""

import collections
import importlib
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from client_tpu_torch.models import DenseNetModel, TinyDecoderModel
from client_tpu_torch.ops import normalize as nz
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)


def _references():
    prompt = [1, 2, 3, 4]
    decoder = TinyDecoderModel(device="cpu")

    def run(tokens, start, end):
        out = decoder.execute({"TOKENS": np.array([tokens], np.int32)},
                              {"sequence_id": 99, "sequence_start": start,
                               "sequence_end": end})
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])

    tokens, _ = chip_smoke.drive_decoder(run, prompt, 8)
    img = np.random.default_rng(0).uniform(0, 255, (224, 224, 3)).astype(np.float32)
    scale, shift = chip_smoke.INCEPTION
    densenet = DenseNetModel(chip_smoke.VISION_CLASSES, chip_smoke.VISION_WIDTH, seed=0,
                             device="cpu")
    data_0 = nz.normalize_image_reference(torch.from_numpy(img), scale, shift,
                                          torch.float32).permute(2, 0, 1).contiguous()
    logits = densenet.execute({"data_0": data_0}, {})["fc6_1"].numpy().reshape(-1)
    return ({"decoder": {"prompt": prompt, "cpu_tokens": tokens}},
            {"cpu_logits": logits.tolist()})


def test_resilience_phase_on_cpu():
    served, vision = _references()
    result = chip_smoke.serve_resilience(served, vision, device="cpu")
    for fault in ("flap", "reset@N"):
        row = result[f"image_client under {fault}"]
        assert row["errors"] == 0 and row["policy"]["retries"] >= 1
        assert row["top1"] == [row["cpu_top1"]] * row["requests"]
    assert result["decoder_lm under reset@N"]["faulted_call_attempts"] == 1
    stream = result["grpc stream auto_reconnect"]
    assert stream["reconnects"] == 1 and stream["tokens"] == stream["cpu_tokens"]
    assert stream["abandoned_request_ids"] == [f"t{chip_smoke.FAULT_STEP}"]
    assert result["breaker"]["transitions"] == ["open", "half_open", "closed"]
    assert result["flight"]["failures_seen"] == 6
    assert set(result["split"]) == {"identity_fp32 4 MiB wire", "identity_fp32 4 MiB cuda shm",
                                    "decoder_lm per token", "image_client cuda shm"}
    assert result["integrity"]["violations"] == 0
    assert result["dataplane"]["cuda"]["regions"] == 0
    assert all(v == 0 for counts in result["launch_counts"].values() for v in counts.values())


# phase 7 at a small size: the same paths, gates and row keys as on the card
SMALL_HARNESS = chip_smoke.HarnessSize(
    identity_bytes=64 * 1024, image=(32, 48, 3), vision_classes=10, vision_width=8, seq=128,
    requests=8, concurrency=(1, 2), prompt=3, output=3, sessions=2,
    replay="mixed:duration_s=1,rate=10,stream_fraction=0.25,seq_fraction=0.15,"
           "output_mean=3,max_output=4")


def test_harness_phase_on_cpu(monkeypatch):
    """``chip_smoke.serve_harness`` at a small size, with the plain
    versions' calls counted here for each path (between the phase's
    ``reset_counts`` and ``read_counts``), so its launch formulas (the
    server's executions, the batched model's rounds and the replayed
    streams' tokens times the layers) are held here as on the card."""
    import collections

    import client_tpu_torch.models.decoder as decoder_mod
    import client_tpu_torch.models.long_context as long_context_mod
    import client_tpu_torch.ops.image as image_mod

    calls = collections.Counter()
    for mod, name in ((decoder_mod, "decode_attention"),
                      (long_context_mod, "flash_attention"),
                      (image_mod, "normalize_image")):

        def counted(*args, _plain=getattr(mod, name), _name=name, **kwargs):
            out = _plain(*args, **kwargs)
            calls[_name] += 1
            return out

        monkeypatch.setattr(mod, name, counted)
    by_path = []
    reset_counts, read_counts = chip_smoke.reset_counts, chip_smoke.read_counts

    def reset():
        calls.clear()
        reset_counts()

    def read():
        by_path.append(dict(calls))
        return read_counts()

    monkeypatch.setattr(chip_smoke, "reset_counts", reset)
    monkeypatch.setattr(chip_smoke, "read_counts", read)
    result = chip_smoke.serve_harness(device="cpu", size=SMALL_HARNESS)
    assert list(result["expected_launches"]) == list(result["launch_counts"])
    assert len(by_path) == len(result["expected_launches"])
    for path, seen in zip(result["expected_launches"], by_path):
        want = {k: v for k, v in result["expected_launches"][path].items() if v}
        assert seen == want, path
    assert all(v == 0 for counts in result["launch_counts"].values() for v in counts.values())
    perf = result["perf"]
    assert set(perf) == {"identity_fp32 none", "identity_fp32 system", "identity_fp32 cuda",
                         "identity_fp32 cuda grpc", "ensemble_image cuda",
                         "long_context_encoder S=128 cuda", "identity_fp32 cuda poisson",
                         "trace replay"}
    for name, entry in perf.items():
        assert all(row["errors"] == 0 for row in entry["rows"]), name
    assert perf["identity_fp32 cuda"]["rows"][0]["client_shm"]["family"] == "cuda"
    assert set(result["genai"]) == {"decoupled tiny_lm_generate c=1",
                                    "sequence decoder_lm_batched c=1",
                                    f"sequence decoder_lm_batched c={chip_smoke.BATCH_SEQS}",
                                    "generate tiny_lm_generate c=1"}
    counts = dict(zip(result["expected_launches"], by_path))
    assert counts["ensemble_image cuda"]["normalize_image"] == \
        perf["ensemble_image cuda"]["executions"] > 0
    assert counts["long_context_encoder S=128 cuda"]["flash_attention"] == \
        perf["long_context_encoder S=128 cuda"]["executions"] > 0
    assert all(counts[path]["decode_attention"] > 0 for path in result["genai"])
    assert counts["trace replay"]["decode_attention"] > 0
    assert all(fam["regions"] == 0 for fam in result["dataplane"].values())


# phase 8 at a small size, its children on the CPU (``serve --device cpu``)
SMALL_PROCESS = chip_smoke.ProcessSize(
    identity_bytes=(64 * 1024, 256 * 1024), load_bytes=64 * 1024, seq=256, image=(64, 64, 3),
    requests=4, concurrency=(1, 2), prompt=[1, 2, 3, 4], steps=3, sessions=2, output=3,
    int8_rounds=1, cli_requests=4)


def test_process_phase_on_cpu(monkeypatch):
    """``chip_smoke.serve_process``: the standalone server in two child
    processes (threaded and aio HTTP frontends), this process the client.
    Every output against the CPU run, every load row and the perf CLI with
    0 errors and the child's success count of the requests sent, the drain
    under load inside the grace window, both children's exit 0 and their
    reports. On the CPU nothing launches (the gate expects zeros), and the
    expected launches are what the card would run."""
    import client_tpu_torch.integrity as integrity

    # the process-default contract cache is keyed by model name: the
    # harness rehearsal's 10-class ensemble_image must not be the contract
    # of the child's 1000-class one
    monkeypatch.setattr(integrity, "_DEFAULT_POLICY", integrity.IntegrityPolicy())
    result = chip_smoke.serve_process(device="cpu", size=SMALL_PROCESS)
    assert result["models"][-5:] == ["identity_fp32", "preprocess", "densenet_onnx",
                                     "ensemble_image", "long_context_encoder"]
    correct = result["correctness"]["threaded"]
    assert correct["decoder"]["http_tokens"] == correct["decoder"]["grpc_tokens"] == \
        correct["decoder"]["cpu_tokens"]
    assert correct["requests"]["identity_fp32"] == 2 * 2 * 3  # sizes x protocols x planes
    assert set(result["load"]) == {"threaded", "aio"}
    for rows in result["load"].values():
        assert set(rows) == {"identity_fp32 cuda", "identity_fp32 none", "ensemble_image cuda",
                             "long_context_encoder cuda"}
        for entry in rows.values():
            assert [r["concurrency"] for r in entry["rows"]] == [1, 2]
            assert all(r["errors"] == 0 for r in entry["rows"])
    assert result["genai"]["tokens"] == SMALL_PROCESS.sessions * SMALL_PROCESS.output
    assert all(r["errors"] == 0 for r in result["perf_cli"]["rows"])
    drain = result["drain"]
    assert drain["errors"] == [] and drain["live_status"] == 200
    assert drain["metrics_ready_0"] and drain["grpc_ready"] is False
    assert drain["checks_done_ms"] < chip_smoke.DRAIN_GRACE_S * 1e3
    assert set(drain["requests"]) == {"long_context_encoder", "ensemble_image"}
    reports = result["reports"]
    assert all(r["rc"] == 0 and r["drain_line"] and r["device"] == "cpu"
               for r in reports.values())
    expected = result["expected_launches"]
    layers = reports["threaded"]["layers"]
    assert expected["threaded"]["decode_attention"] == layers * 2 * (4 + SMALL_PROCESS.steps)
    assert expected["aio"]["decode_attention"] == layers * reports["aio"]["rounds"] > 0
    for name in ("threaded", "aio"):
        ex = reports[name]["executions"]
        assert expected[name]["flash_attention"] == ex["long_context_encoder"] > 0
        assert expected[name]["normalize_image"] == ex["ensemble_image"] > 0
    assert all(v == 0 for counts in result["launch_counts"].values() for v in counts.values())


# phase 9 at a small size, its two "children" port servers in this process
SMALL_POOL = chip_smoke.PoolSize(
    image=(64, 64, 3), rr_requests=4, prompt=[1, 2, 3, 4], steps=3, seq=256,
    affinity_keys=2, affinity_requests=2, hedge_requests=2, threads=4, coalesce_rows=4,
    window_us=20000, offered=20, offered_s=0.5, steady=4, aio_requests=4, concurrency=(1, 2),
    perf_requests=4, failover_workers=2, failover_after=4)


class InProcessChild:
    """A ``serve`` child's surface (URLs, SIGTERM drain, final report) over
    port servers in this process: the served set of ``SERVE_ARGS`` on the
    CPU, drained as ``serve`` drains (ready false, the grace, then close)."""

    def __init__(self):
        from client_tpu_torch.models import build_image_ensemble, default_model_zoo
        from client_tpu_torch.models.long_context import LongContextEncoderModel
        from client_tpu_torch.models.simple import IdentityModel
        from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore

        models = (default_model_zoo("cpu") + [IdentityModel("identity_fp32", "FP32", device="cpu")]
                  + build_image_ensemble(device="cpu")
                  + [LongContextEncoderModel(attention="flash", device="cpu")])
        self.core = ServerCore(models, device="cpu")
        self.servers = [HttpInferenceServer(self.core), GrpcInferenceServer(self.core)]
        self.drainer = None

    def wait_ready(self):
        for s in self.servers:
            s.start()
        self.http_url, self.grpc_url = (s.url for s in self.servers)
        return self

    def _drain(self):
        self.core.ready = False
        time.sleep(chip_smoke.DRAIN_GRACE_S)
        for s in self.servers:
            s.close(grace_s=0.0)

    def sigterm(self):
        self.drainer = threading.Thread(target=self._drain)
        self.drainer.start()

    def finish(self, t0, timeout):
        self.drainer.join(timeout)
        stats = self.core.statistics()["model_stats"]
        return {"rc": 0, "launches": None, "device": "cpu", "drain_line": True,
                "executions": {r["name"]: r["execution_count"] for r in stats},
                "failures": {r["name"]: r["inference_stats"]["fail"]["count"] for r in stats},
                "rounds": sum(self.core.model("decoder_lm_batched").batch_histogram.values()),
                "layers": self.core.model("decoder_lm").LAYERS,
                "exit_s": time.perf_counter() - t0}

    def terminate(self):
        t0 = time.perf_counter()
        self.sigterm()
        return self.finish(t0, 15.0)

    def kill(self):
        if self.drainer is None:
            for s in self.servers:
                s.stop()


def test_pool_phase_on_cpu(monkeypatch):
    """``chip_smoke.serve_pool``: every row of phase 9 against two port
    servers in this process, with the plain versions' calls counted here
    for each row (between the phase's ``reset_counts`` and
    ``read_counts``): their sum over the rows is the children's expected
    launches (their executions), as on the card."""
    import client_tpu_torch.integrity as integrity
    import client_tpu_torch.models.decoder as decoder_mod
    import client_tpu_torch.models.long_context as long_context_mod
    import client_tpu_torch.ops.image as image_mod

    monkeypatch.setattr(integrity, "_DEFAULT_POLICY", integrity.IntegrityPolicy())
    calls = collections.Counter()
    for mod, name in ((decoder_mod, "decode_attention"),
                      (long_context_mod, "flash_attention"),
                      (image_mod, "normalize_image")):

        def counted(*args, _plain=getattr(mod, name), _name=name, **kwargs):
            out = _plain(*args, **kwargs)
            calls[_name] += 1
            return out

        monkeypatch.setattr(mod, name, counted)
    by_row = collections.Counter()
    reset_counts, read_counts = chip_smoke.reset_counts, chip_smoke.read_counts

    def reset():
        calls.clear()
        reset_counts()

    def read():
        by_row.update(calls)
        return read_counts()

    monkeypatch.setattr(chip_smoke, "reset_counts", reset)
    monkeypatch.setattr(chip_smoke, "read_counts", read)
    result = chip_smoke.serve_pool(device="cpu", size=SMALL_POOL,
                                   start_children=lambda: [InProcessChild(), InProcessChild()])
    rows = result["rows"]
    assert rows["round robin"]["executions"] == [2, 2]
    assert sorted(rows["sequence"]["executions"]) == [0, SMALL_POOL.steps + 1]
    assert all(sorted(split) == [0, 2] for split in rows["affinity"]["keys"].values())
    assert all(rows["hedge"]["executions"])
    assert (rows["singleflight"]["wire_requests"],
            rows["singleflight"]["singleflight_collapsed"]) == (1, 3)
    assert sum(rows["coalescing"]["executions"]) < SMALL_POOL.coalesce_rows
    assert rows["tenancy"]["verdicts"].get("steady ok") and \
        rows["tenancy"]["verdicts"]["burst over_quota"] >= 10
    assert rows["failover"]["health_changes"] == 1 and not rows["failover"]["errors"]
    assert [r["concurrency"] for r in rows["perf"]["pool of two"]] == [1, 2]
    total = {k: sum(e[k] for e in result["expected_launches"])
             for k in result["expected_launches"][0]}
    assert dict(by_row) == total and all(total.values())
    layers = result["reports"][0]["layers"]
    assert total["decode_attention"] == layers * (4 + SMALL_POOL.steps)


# phase 10 at a small size: four port servers in this process, the last two
# behind a ChaosProxy whose reset stands for the SIGKILL
SMALL_ORCH = chip_smoke.OrchSize(
    prompts=2, prompt_len=6, max_tokens=8, kill_after=3, abandon_after=2, shard_rows=4,
    shard_len=5, matmul_rows=5, chain_runs=3, image=(64, 64, 3), concurrency=(1, 2),
    perf_requests=4, records=4,
    mixed=("mixed:duration_s=1,rate=16,stream_fraction=0.1,seq_fraction=0.1,"
           "shard_fraction=0.25,shard_model=decoder_lm_prefill,disagg_fraction=0.25,"
           "pipeline_fraction=0.25,max_prompt=8,max_output=4"))


class CountingChild(InProcessChild):
    """An in-process child whose report carries its decoder's steps."""

    def __init__(self):
        super().__init__()
        decoder = self.core.model("decoder_lm")
        plain, lock = decoder.step, threading.Lock()
        self.steps = 0

        def step(*args, **kwargs):
            with lock:
                self.steps += 1
            return plain(*args, **kwargs)

        decoder.step = step

    def finish(self, t0, timeout):
        return dict(super().finish(t0, timeout), decoder_steps=self.steps)


class VictimChild(CountingChild):
    """A child behind a proxy: ``kill`` resets its connections, the one in
    flight and every later one, as a SIGKILLed process's port would."""

    def wait_ready(self):
        super().wait_ready()
        from client_tpu_torch.testing import ChaosProxy

        self.proxy = ChaosProxy("127.0.0.1", self.servers[0].port).start()
        self.http_url = self.proxy.url
        return self

    def kill(self):
        from client_tpu_torch.testing import Fault

        self.proxy.fault = Fault("reset", after_bytes=0)
        self.proxy.reset_active()

    def stop(self):
        self.proxy.stop()
        for s in self.servers:
            s.stop()


class Lockstep:
    """How far the client's disagg session has come back for tokens: its
    generator resumed after ``count`` tokens (after the loop body that acted
    on the last one), or every wait released once the victim is killed."""

    def __init__(self):
        self._cond = threading.Condition()
        self.count = 0
        self.released = False

    def reset(self):
        with self._cond:
            self.count = 0

    def advance(self):
        with self._cond:
            self.count += 1
            self._cond.notify_all()

    def release(self):
        with self._cond:
            self.released = True
            self._cond.notify_all()

    def wait_for(self, count, timeout=30.0):
        with self._cond:
            if not self._cond.wait_for(lambda: self.released or self.count >= count, timeout):
                raise TimeoutError(f"the client never came back for token {count + 1}")


class LockstepVictim(VictimChild):
    """The lone decode replica of the recovery row: the step after the j-th
    token of a decode leg waits until the client has come back for token
    j + 1, so the client's kill after ``abandon_after`` tokens always lands
    before the next token exists (none is left in flight to arrive after it)."""

    def __init__(self, lockstep):
        super().__init__()
        self.lockstep = lockstep
        self.stream_steps = 0
        kv = self.core.model("decoder_lm_kv_decode")
        decoder = self.core.model("decoder_lm")
        leg, counted = kv.execute_decoupled, decoder.step

        def execute_decoupled(*args, **kwargs):
            self.stream_steps = 0
            yield from leg(*args, **kwargs)

        def step(*args, **kwargs):
            self.stream_steps += 1
            lockstep.wait_for(self.stream_steps)
            return counted(*args, **kwargs)

        kv.execute_decoupled = execute_decoupled
        decoder.step = step

    def kill(self):
        super().kill()
        self.lockstep.release()


def test_orchestration_phase_on_cpu(monkeypatch):
    """``chip_smoke.serve_orchestration``: every row of phase 10 on four port
    servers in this process (the lone decode replica in lockstep with the
    client, see :class:`LockstepVictim`). The plain normalize calls counted here over the
    rows equal the drained children's expected normalize launches (their
    preprocess and ensemble_image executions), and every plain decode call
    of the test is one a layer of a decoder step: the four children's and
    the CPU references' (a victim's stream may step on after its row, until
    its writes fail)."""
    import client_tpu_torch.integrity as integrity
    import client_tpu_torch.models.decoder as decoder_mod
    import client_tpu_torch.ops.image as image_mod

    monkeypatch.setattr(integrity, "_DEFAULT_POLICY", integrity.IntegrityPolicy())
    calls, totals = collections.Counter(), collections.Counter()
    for mod, name in ((decoder_mod, "decode_attention"), (image_mod, "normalize_image")):

        def counted(*args, _plain=getattr(mod, name), _name=name, **kwargs):
            out = _plain(*args, **kwargs)
            calls[_name] += 1
            totals[_name] += 1
            return out

        monkeypatch.setattr(mod, name, counted)
    by_row = collections.Counter()
    reset_counts, read_counts = chip_smoke.reset_counts, chip_smoke.read_counts

    def reset():
        calls.clear()
        reset_counts()

    def read():
        by_row.update(calls)
        return read_counts()

    monkeypatch.setattr(chip_smoke, "reset_counts", reset)
    monkeypatch.setattr(chip_smoke, "read_counts", read)
    lockstep = Lockstep()

    class LockstepDisaggClient(chip_smoke.DisaggClient):
        def generate_stream(self, *args, **kwargs):
            lockstep.reset()
            for event in super().generate_stream(*args, **kwargs):
                yield event
                lockstep.advance()

    monkeypatch.setattr(chip_smoke, "DisaggClient", LockstepDisaggClient)
    children = [CountingChild(), CountingChild(), VictimChild(), LockstepVictim(lockstep)]
    try:
        result = chip_smoke.serve_orchestration(device="cpu", size=SMALL_ORCH,
                                                start_children=lambda: children)
    finally:
        for child in children[2:]:
            child.stop()
    rows = result["rows"]
    urls = result["urls"]
    dg = rows["disagg"]
    assert dg["near_ties"] == [None] * SMALL_ORCH.prompts
    assert (dg["steady_region_creates"], dg["steady_registrations"]) == (0, 0)
    assert dg["tampered"]["field"] == "digest" and dg["tampered_session"]["tokens_before"] == 0
    assert dg["aio_equal"] and dg["family"] == "system"
    rc = rows["recovery"]
    assert rc["decode_legs"][0] == urls[2] and rc["resumed_on"] == urls[1]
    assert rc["abandoned"]["url"] == urls[3]
    assert rc["abandoned"]["emitted"] == SMALL_ORCH.abandon_after
    assert rows["shard"]["killed_shard"]["shard"] == 1
    assert rows["shard"]["killed_shard"]["url"] == urls[2]
    assert rows["shard"]["decoder_lm_prefill"]["max_abs_diff_vs_one_call"]["NEXT_TOKEN"] == 0
    assert rows["shard"]["decoder_lm_prefill"]["near_tie_rows"] == []
    assert rows["pipeline"]["chain_max_abs_diff_vs_cpu"] == 0
    pl = rows["pipeline"]
    assert pl["vision"]["top1"] == pl["vision"]["cpu_top1"]
    assert pl["vision"]["max_abs_logit_diff_vs_cpu"] < 1e-4
    assert (pl["steady_region_creates"], pl["steady_registrations"]) == (0, 0)
    harness = rows["harness"]
    assert set(harness) == {"shard_layout", "roles", "pipeline", "mixed replay"}
    assert harness["roles"]["children_successes"] == [SMALL_ORCH.records * 2] * 2
    assert all(v["ok"] for v in harness["mixed replay"]["rows"]["kinds"].values())
    expected = result["expected_launches"]
    assert by_row["normalize_image"] == sum(e["normalize_image"] for e in expected) > 0
    layers = result["reports"][0]["layers"]
    reference_steps = (SMALL_ORCH.prompts * (SMALL_ORCH.prompt_len + SMALL_ORCH.max_tokens - 1)
                       + SMALL_ORCH.shard_rows * SMALL_ORCH.shard_len)
    deadline = time.monotonic() + 10
    while totals["decode_attention"] != layers * (sum(c.steps for c in children)
                                                  + reference_steps):
        assert time.monotonic() < deadline, (totals, [c.steps for c in children])
        time.sleep(0.05)
    assert sum(e["decode_attention"] for e in expected) == \
        layers * (children[0].steps + children[1].steps) > 0
    assert result["launch_counts"] == [None, None]


def test_kernels_line_and_last_line_keep_the_contract():
    """``main`` still prints the six kernels with every key of the contract,
    and the ``{"ok": true, "device": {"platform": "gpu", ...}}`` line last;
    without a card it fails before any of them."""
    import inspect

    source = inspect.getsource(chip_smoke.main)
    for name in ("decode_attention", "flash_attention", "quantize_int8", "dequantize_int8",
                 "normalize_image", "softmax_probabilities"):
        assert f'"{name}"' in source
    for key in ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "orchestration_launches",
                "federation_launches", "mesh_launches"):
        assert f'"{key}":' in source, key
    lines = [line.strip() for line in source.rstrip().splitlines()]
    k = lines.index('log(json.dumps({"kernels": kernels}))')
    assert lines[k - 1] == "log(smi)"  # the card's name and power limit
    assert '"ok": True' in lines[k + 1] and '"platform": "gpu"' in lines[k + 1]
    assert lines[-1] == "return 0" and not any("log(" in line for line in lines[k + 2:])
    if not torch.cuda.is_available():
        assert chip_smoke.main([]) != 0


# phase 11 at a small size: four port servers in this process, each behind
# the phase's own proxy; the doctor row's SIGKILL of child 4 is stood in by
# that proxy's reset (a server stopped in process keeps serving its open
# keep-alive connections)
SMALL_FED = chip_smoke.FedSize(
    seq=256, home_requests=4, spill_requests=12, blackhole_after=3, heal_after=8,
    return_max=200, prompt=[1, 2, 3, 4], seq_tokens=4, shadow_requests=3, canary_healthy=6,
    canary_max=20, canary_after=4, canary_slo_ms=100.0, canary_latency_s=0.2, byz_requests=6,
    watch_warm=64, watch_batch=8, watch_batches=32, watch_latency_s=0.1, watch_slo_ms=100.0,
    watch_fast_s=2.0, watch_window_s=6.0, perf_requests=4, concurrency=(1, 2))


def test_federation_phase_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.serve_federation``: every row of phase 11 on four port
    servers in this process. The plain attention calls counted here over
    the rows are the expected launches: flash_attention = the encoder's
    calls a request times the encoder executions of the four children and
    of the byzantine core, decode_attention = layers x the children's
    decoder steps."""
    import client_tpu_torch.integrity as integrity
    import client_tpu_torch.models.decoder as decoder_mod
    import client_tpu_torch.models.long_context as long_context_mod

    monkeypatch.setattr(integrity, "_DEFAULT_POLICY", integrity.IntegrityPolicy())
    calls = collections.Counter()
    for mod, name in ((decoder_mod, "decode_attention"),
                      (long_context_mod, "flash_attention")):

        def counted(*args, _plain=getattr(mod, name), _name=name, **kwargs):
            out = _plain(*args, **kwargs)
            calls[_name] += 1
            return out

        monkeypatch.setattr(mod, name, counted)
    encoder = long_context_mod.LongContextEncoderModel(device="cpu")
    calls.clear()
    encoder.execute({"sequence": np.zeros((8, encoder.encoder.dim), np.float32)}, {})
    flash_per_request = calls["flash_attention"]
    by_row = collections.Counter()
    reset_counts, read_counts = chip_smoke.reset_counts, chip_smoke.read_counts

    def reset():
        calls.clear()
        reset_counts()

    def read():
        by_row.update(calls)
        return read_counts()

    monkeypatch.setattr(chip_smoke, "reset_counts", reset)
    monkeypatch.setattr(chip_smoke, "read_counts", read)
    children = [CountingChild() for _ in range(4)]
    try:
        result = chip_smoke.serve_federation(device="cpu", size=SMALL_FED,
                                             start_children=lambda: children,
                                             out_dir=str(tmp_path))
    finally:
        children[3].drainer = None
        for s in children[3].servers:
            s.stop()
    rows = result["rows"]
    assert rows["home"]["executions"][2:] == [0, 0] and rows["home"]["spills"] == 0
    spill = rows["spill"]
    assert spill["spills"] == spill["executions"][2] > 0 and spill["requests_to_return_home"] > 0
    assert set(spill["reasons"]) <= {"down", "error"}
    seq = rows["sequence"]
    assert seq["abandoned"]["sequence_id"] == 4242 and seq["executions"][2:] == [0, 0]
    assert seq["near_tie"] is None and seq["tokens"] == seq["cpu_tokens"]
    assert rows["shadow"]["status"]["matched"] == SMALL_FED.shadow_requests
    assert rows["canary"]["status"]["weight"] == 0.0 and rows["canary"]["executions_after"][3] == 0
    byz = rows["byzantine"]
    assert byz["corrupt_returned"] == 0 and byz["returned"] == SMALL_FED.byz_requests
    assert set(byz["faults"]) <= set(chip_smoke.BYZ_KINDS)
    assert byz["liar"]["pool"]["quarantine_dominated"] and byz["liar"]["pool"]["invalid_total"]
    watch = rows["watch"]
    assert watch["faulted_url"] in str(watch["named"]["evidence"])
    # past watch_batches only while the burn alert fired, as many again at most
    assert watch["batches"] <= 2 * SMALL_FED.watch_batches
    assert watch["burn_wait_batches"] == max(0, watch["batches"] - SMALL_FED.watch_batches)
    assert watch["ring_records"]["alert"] >= 2 and watch["timelines_recovered"]
    assert [r["concurrency"] for r in rows["harness"]["rows"]] == [1, 2]
    assert rows["doctor"]["cells"] == ["away", "canary", "home"]
    assert "cell_down" in rows["doctor"]["killed_anomalies"]
    executions = [sum(r["executions"]["long_context_encoder"] for r in result["reports"]),
                  children[3].core.statistics("long_context_encoder")["model_stats"][0][
                      "execution_count"],
                  byz["byzantine_executions"]]
    assert by_row["flash_attention"] == flash_per_request * sum(executions) > 0
    layers = result["reports"][0]["layers"]
    expected = result["expected_launches"]
    assert sum(e["decode_attention"] for e in expected) == layers * sum(
        c.steps for c in children[:3]) > 0
    assert by_row["decode_attention"] == layers * sum(c.steps for c in children)
    assert result["launch_counts"] == [None, None, None]
    assert result["client_counts"]["byzantine"]["flash_attention"] == 0


# phase 12 at a small size: the same rows and gates on CPU shards, the serve
# child with --device cpu (eight mesh entries of the CPU)
SMALL_MESH = chip_smoke.MeshSize(
    shards=(1, 2, 4), prompts=2, prompt_len=3, steps=2, concurrent=2, prefill_rows=2,
    prefill_len=4, seq=256, cpu_seq=128, causal=(1, 128, 4, 16), encoder_requests=1,
    moe_tokens=64, pipe=(4, 4, 8, 16), vision=(16, 8), vision_requests=1)


def test_mesh_phase_on_cpu(monkeypatch, one_intra_op_thread):
    """``chip_smoke.serve_mesh``: every row of phase 12 on CPU shards, on
    one intra-op thread here and in its ``serve`` child (the phase took
    over 100 s beside six busy torch processes against its 60 s limit). The
    plain decode_attention calls of the tp decoder counted here are the
    launches the card must show: tokens x layers x shards of each run."""
    import client_tpu_torch.models.decoder_tp as decoder_tp

    calls = collections.Counter()
    plain = decoder_tp.decode_attention

    def counted(*args, **kwargs):
        calls["decode_attention"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(decoder_tp, "decode_attention", counted)
    result = chip_smoke.serve_mesh(device="cpu", size=SMALL_MESH)
    chip_smoke.log_mesh(result, "cpu")  # main's lines format this result
    rows = result["rows"]
    size, layers = SMALL_MESH, TinyDecoderModel.LAYERS
    tokens = size.prompt_len + size.steps
    dt = rows["decoder_lm_tp"]
    assert set(dt["by_shards"]) == set(size.shards)
    for n, entry in dt["by_shards"].items():
        assert entry["tokens"] == dt["decoder_lm_tokens"] == dt["cpu_tokens"]
        assert entry["logits_bit_equal"] and all(entry["concurrent_equal"])
        assert entry["launches"] == {k: 0 for k in chip_smoke.COUNTERS}
    pf = rows["decoder_lm_tp_prefill"]
    assert pf["zoo_tp_degree"] == 4
    assert pf["served"]["bit_equal"] and pf["4 shards"]["bit_equal"]
    # each mesh size: one warm stream, the prompts, then the concurrent run
    decode_steps = sum(size.shards) * (1 + size.prompts + size.concurrent) * tokens
    prefill_steps = 2 * 4 * size.prefill_rows * size.prefill_len
    assert calls["decode_attention"] == layers * (decode_steps + prefill_steps)
    enc = rows["long_context_encoder"]
    assert set(enc["modes"]) == {"ring", "ulysses", "auto"}
    assert enc["modes"]["auto"]["runs"] == "ulysses"
    assert all(r["max_abs_err_vs_flash"] < 2e-4 for r in enc["modes"].values())
    moe = rows["moe_ffn"]
    assert moe["refused_status"] == "400" and moe["dropped"] > 0 and moe["kept"] > 0
    assert moe["experts"] == 8 and rows["pipeline"]["max_abs_err"] < 1e-5
    assert rows["densenet_onnx"]["tp"] == 2
    child = rows["serve_child"]
    assert "moe_ffn data=1 model=8" in child["degrees"] and child["drained"]
    assert child["device"] == "cpu"


# phase 13 at a small width: the dry run, the step at dp 2 x tp 4 and at one
# shard, the multihost child over gloo and entry() on the CPU
SMALL_TRAIN = chip_smoke.TrainSize(dryrun_devices=8, classes=16, width=8, image=32, batch=16,
                                   cpu_batch=2, steps=1, lr=1e-3, entry_iters=1)


@pytest.fixture
def one_intra_op_thread(monkeypatch):
    """torch's CPU ops on one thread, here and in the multihost child
    (``OMP_NUM_THREADS``). The phase's CPU mesh runs thousands of small
    ops; with torch's default pool (a thread a core) in each of the
    suite's six workers, the cores are oversubscribed and those ops slow
    down about tenfold: the phase took 88 s under such a load against
    its 60 s limit, and 13 s alone. One thread gives the same bits."""
    before = torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_training_phase_on_cpu(monkeypatch, one_intra_op_thread):
    """``chip_smoke.serve_training`` on the CPU. The plain decode_attention
    calls counted here are the launches the card must show: fed tokens x
    layers x shards for the dry run's served decode, fed tokens x layers
    for its reference."""
    import client_tpu_torch.models.decoder as decoder
    import client_tpu_torch.models.decoder_tp as decoder_tp

    calls = collections.Counter()
    for module in (decoder, decoder_tp):
        plain = module.decode_attention

        def counted(*args, _plain=plain, _name=module.__name__, **kwargs):
            calls[_name] += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, "decode_attention", counted)
    result = chip_smoke.serve_training(device="cpu", size=SMALL_TRAIN)
    chip_smoke.log_training(result, "cpu")  # main's lines format this result
    rows = result["rows"]
    dr = rows["dryrun"]
    assert dr["result"]["mesh"] == {"data": 2, "model": 4}
    assert calls[decoder_tp.__name__] == dr["expected_launches"]["served"] == 6 * 2 * 4
    assert calls[decoder.__name__] == dr["expected_launches"]["reference"] == 6 * 2
    assert result["launch_counts"]["dryrun"] == {k: 0 for k in chip_smoke.COUNTERS}
    ts = rows["train_step"]
    assert ts["dp2_tp4"]["shape"] == {"data": 2, "model": 4}
    assert ts["one_shard"]["shape"] == {"data": 1, "model": 1}
    assert ts["dp2_tp4_vs_one_shard"]["min_cosine"] >= 0.99
    assert ts["dp2_tp4_vs_one_shard"]["leaves"] == 30
    # the same device against itself: bit for bit
    assert ts["vs_cpu"]["loss_diff"] == 0 and ts["vs_cpu"]["max_fraction"] == 0
    assert ts["dp2_tp4"]["device_idle_share"] is None  # no device to profile
    mh = rows["multihost"]
    assert mh["backend"] == "gloo" and mh["dp_step_max_rel_err"] < 2e-4
    assert rows["entry"]["shape"] == [4, 1000] and rows["entry"]["max_abs_err_vs_cpu"] == 0


# phase 14 at a small size: the embed library in this process, the C host
# as a child, and the native clients against CPU servers of the port
SMALL_NATIVE = chip_smoke.NativeSize(
    identity_bytes=1 << 20, iters=2, seq=256, vision_classes=16, vision_width=8,
    prompt=[1, 2, 3, 4], steps=8, perf_requests=6, concurrency=(1, 2))


@pytest.fixture(scope="module")
def native_libraries():
    """The three host builds, once for the file and before any test's time
    limit (a parallel worker's build is waited for under the file lock)."""
    return chip_smoke.native_build.build_all()


def test_native_phase_on_cpu(monkeypatch, native_libraries, one_intra_op_thread):
    """``chip_smoke.serve_native``: every row of phase 14 on the CPU. The
    plain decode_attention calls counted here are the launches the card
    must show on the embedded and streamed paths (tokens x layers), beside
    the warm token and the in-process reference's."""
    import client_tpu_torch.models.decoder as decoder

    calls = collections.Counter()
    plain = decoder.decode_attention

    def counted(*args, **kwargs):
        calls["decode_attention"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(decoder, "decode_attention", counted)
    size, layers = SMALL_NATIVE, TinyDecoderModel.LAYERS
    stepped = len(size.prompt) + size.steps
    result = chip_smoke.serve_native(device="cpu", size=size)
    chip_smoke.log_native(result, "cpu")  # main's lines format this result
    assert result["missing_for_clients"] == []
    assert set(result["builds"]) == {"embed", "embed_host", "http"}
    em, host = result["embedded"], result["embed_host"]
    assert em["tokens"] == em["in_process_tokens"] and em["logits_bit_equal"]
    assert em["statistics_success"] == {"simple": 1, "decoder_lm": size.steps + 2}
    assert host["exit"] == 0 and host["tokens"] == em["tokens"] and host["logits_bit_equal"]
    assert host["statistics_success"] == {"simple": 1, "decoder_lm": size.steps + 1}
    rows = result["clients"]
    for name in ("http", "grpc"):
        assert rows[f"identity_fp32 {name}"]["requests"] == 2 * (size.iters + 1)
        lc = rows[f"long_context_encoder {name}"]
        assert lc["max_abs_diff_vs_cpu"] <= lc["tol"] and lc["seq"] == size.seq
        ens = rows[f"ensemble_image {name}"]
        assert ens["top1"] == [ens["cpu_top1"]]
        expected = result["expected_launches"]
        assert expected[f"long_context_encoder {name}"] == {"flash_attention": size.iters + 1}
        assert expected[f"ensemble_image {name}"] == {"normalize_image": size.iters}
    stream = rows["decoder_lm native grpc stream"]
    assert stream["tokens"] == em["tokens"]
    perf = rows["perf native-grpc cuda"]
    assert perf["sent"] == perf["server_successes"] > 0
    assert [r["concurrency"] for r in perf["rows"]] == list(size.concurrency)
    assert result["expected_launches"]["embedded"] == {"decode_attention": stepped * layers}
    assert result["expected_launches"]["decoder_lm native grpc stream"] == {
        "decode_attention": stepped * layers}
    # on the CPU the wrappers run their plain versions and launch nothing
    assert all(c == {k: 0 for k in chip_smoke.COUNTERS}
               for c in result["launch_counts"].values())
    # the warm token, the embedded run, its in-process reference, the stream
    assert calls["decode_attention"] == layers * (1 + 3 * stepped)


# phase 15 at narrow widths that keep the published head dims, 96
# (Phi-3-mini's) and 256 (Gemma-2B's), and the head dim past 256 (512),
# two heads each
SMALL_WIDE = chip_smoke.WideSize(
    widths=(("head_dim_96", 192, 2, 64), ("head_dim_256", 512, 2, 64),
            ("head_dim_512", 1024, 2, 64)),
    wire_seq=32, requests=2, child_profiled=("head_dim_96", "head_dim_256"))


def test_wide_encoder_phase_on_cpu(monkeypatch):
    """``chip_smoke.serve_wide_encoder``: phase 15 on the CPU. Each width's
    encoder serves S = 64 over cuda shm (CPU regions) against the plain
    version with the same weights and S = 32 over the wire against the CPU
    run; the wrapper's plain calls, counted here, equal the server's
    executions in each row (the card would launch the kernel as often; the
    phase's own gate expects 0 launches on the CPU), and the statistics
    count the requests."""
    import sys

    module = sys.modules["client_tpu_torch.ops.flash_attention"]
    calls = []
    real = module.flash_attention_reference
    monkeypatch.setattr(module, "flash_attention_reference",
                        lambda *args, **kwargs: calls.append(args[0].shape) or real(*args,
                                                                                   **kwargs))
    result = chip_smoke.serve_wide_encoder(device="cpu", size=SMALL_WIDE)
    rows = result["rows"]
    assert [(r["width"], r["head_dim"]) for r in rows] == [
        ("head_dim_96", 96), ("head_dim_256", 256), ("head_dim_512", 512)]
    executions = 0
    for row in rows:
        assert row["cuda_shm_vs_plain_max_abs_err"] <= 2e-5
        assert row["wire_vs_cpu_max_abs_err"] <= 2e-5
        for plane, sent in (("cuda_shm", 1 + SMALL_WIDE.requests), ("wire", 1)):
            r = row[plane]
            assert r["requests"] == r["executions"] == r["successes"] == sent
            assert not any(r["launches"].values())
            executions += r["executions"]
        assert row["attention_gflop"] == 4 * row["heads"] * 64 * 64 * row["head_dim"] / 1e9
    # every served execution ran the wrapper once, at its head dim, and so
    # did each width's CPU run that the wire row is held against
    assert len(calls) == executions + len(rows)
    assert {shape[-1] for shape in calls} == {96, 256, 512}
    # the card's rows: Phi-3-mini's and Gemma-2B's widths at S = 8192, the
    # head dim 512 width at S = 1024, and their bounds as the kernel table
    # reckons them
    assert chip_smoke.WIDE.widths == (("phi3_mini", 3072, 32, 8192), ("gemma_2b", 2048, 8, 8192),
                                      ("head_dim_512", 2048, 4, 1024))
    assert chip_smoke.WIDE.child_profiled == ("phi3_mini", "gemma_2b")
    bounds = [chip_smoke.wide_bounds(seq, dim, heads)
              for _, dim, heads, seq in chip_smoke.WIDE.widths]
    assert [round(b["attention_gflop"], 1) for b in bounds] == [824.6, 549.8, 8.6]
    assert [round(b["attention_bound_ms"], 2) for b in bounds] == [12.31, 8.21, 0.13]
    assert [round(b["projections_gflop"], 1) for b in bounds] == [618.5, 274.9, 34.4]
    # the card's profiled request in a process of its own: on the CPU the
    # child serves and profiles one request, and its trace holds no kernel
    child = chip_smoke.wide_profile_in_child(96, 4, 32, "cpu")
    assert child["wall_ms"] > 0 and child["device_ms"] is None


def test_tiled_mismatches_explain_only_l_order():
    """``chip_smoke.tiled_mismatches``, phase 3's gate on the integer
    kernels against their tiled plain versions: a difference is explained
    only where it is 1 and the plain version's quotient lies within 2^-18
    of an integer (l's summation order moves trunc(acc / l) there and
    nowhere else); any other difference, and any bool difference, is not."""
    ref = torch.tensor([3, -2, 5, 0, 7], dtype=torch.int8)
    quotient = torch.tensor([3.0, -2.0, 5.5, 0.25, 7.0])
    assert chip_smoke.tiled_mismatches(ref.clone(), ref, quotient) == (0, 0)
    # 3.0 read as 2.999999: trunc 2, explained; 5.5 read as 4: not
    out = torch.tensor([2, -2, 4, 0, 7], dtype=torch.int8)
    assert chip_smoke.tiled_mismatches(out, ref, quotient) == (2, 1)
    # a difference of 2 is never explained
    out = torch.tensor([3, -2, 5, 0, 5], dtype=torch.int8)
    assert chip_smoke.tiled_mismatches(out, ref, quotient) == (1, 1)
    flags = torch.tensor([True, False, True])
    assert chip_smoke.tiled_mismatches(~flags, flags, flags.float()) == (3, 3)


def test_build_fails_on_a_spill_in_the_held_kernels():
    """``chip_smoke.ptxas_spills``, the build's gate: a spill in the softmax,
    normalize or int8 kernels or in either wide flash kernel fails the
    build; a spill elsewhere (a dense flash instantiation) and a line with
    0 bytes spilled do not."""
    wide = ("flash_attention: <unnamed>::flash_attention_mma_wide_kernel<__half>: "
            "8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads")
    f32 = ("flash_attention: <unnamed>::flash_attention_f32_wide_kernel: "
           "0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads")
    clean = ("flash_attention: <unnamed>::flash_attention_f32_wide_kernel: "
             "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
    dense = ("flash_attention: <unnamed>::flash_attention_mma_kernel<__half, (int)256, "
             "(bool)0>: 8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads")
    softmax = "softmax: softmax_rows_kernel: 0 bytes stack frame, 12 bytes spill stores"
    registers = ("flash_attention: <unnamed>::flash_attention_f32_wide_kernel: ptxas info    "
                 ": Used 168 registers, used 1 barriers")
    lines = [wide, f32, clean, dense, softmax, registers]
    assert chip_smoke.ptxas_spills(lines) == [wide, f32, softmax]
    assert chip_smoke.ptxas_spills([clean, dense, registers]) == []


def test_build_fails_on_a_spill_in_the_3xtf32_kernel():
    """The spill gate holds the fp32 flash kernel for head dims 33-256
    (3xTF32 on the tensor cores) too, every instantiation; the fp32 kernel
    for head dims up to 32 stays outside it."""
    spilled = ("flash_attention: <unnamed>::flash_attention_f32_tc_kernel<(int)64, (bool)0>: "
               "24 bytes stack frame, 52 bytes spill stores, 40 bytes spill loads")
    clean = ("flash_attention: <unnamed>::flash_attention_f32_tc_kernel<(int)256, (bool)1>: "
             "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
    small = ("flash_attention: <unnamed>::flash_attention_f32_small_kernel<(int)32, (bool)1>: "
             "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads")
    assert chip_smoke.ptxas_spills([spilled, clean, small]) == [spilled]


def test_flash_bound_counts_3xtf32_at_the_tf32_peak():
    """fp32 flash at head dims 33-256 is bounded by three TF32 products a
    product at the 495 TFLOP/s TF32 peak, the fp32 FMA bound kept beside;
    fp32 at D <= 32 and past 256 stays at the FMA rate, bf16 at its own."""
    shape = (1, 8192, 32, 96)
    flops = 4 * 32 * 8192 * 8192 * 96
    bound, by = chip_smoke.flash_bound(shape, False, "float32")
    assert by == "operations" and bound == pytest.approx(3 * flops / 495e12 * 1e3)
    basis = chip_smoke.flash_bound_basis(shape, False, "float32")
    assert basis["bound_basis"].startswith("3xTF32")
    assert basis["fma_bound_ms"] == pytest.approx(flops / 67e12 * 1e3)
    for d in (32, 257):
        narrow = (1, 4096, 4, d)
        assert chip_smoke.flash_bound(narrow, True, "float32")[0] == pytest.approx(
            4 * 4 * (4096 * 4097 // 2) * d / 67e12 * 1e3)
        assert "fma_bound_ms" not in chip_smoke.flash_bound_basis(narrow, True, "float32")
    assert chip_smoke.flash_bound(shape, False, "bfloat16")[0] == pytest.approx(
        flops / 989e12 * 1e3)


def test_flash_bound_reads_the_3xtf32_dims_from_the_module(monkeypatch):
    """``chip_smoke`` takes the head dims the 3xTF32 kernel runs at from
    the flash module (``TF32_DIMS``), and bounds a tree whose module has no
    ``runs_3xtf32`` (an earlier tree under ``--kernel-times``) at the fp32
    FMA rate."""
    module = importlib.import_module("client_tpu_torch.ops.flash_attention")
    shape = (1, 4096, 8, 128)
    flops = 4 * 8 * 4096 * 4096 * 128
    assert chip_smoke.flash_bound(shape, False, "float32")[0] == pytest.approx(
        3 * flops / 495e12 * 1e3)
    monkeypatch.setattr(module, "TF32_DIMS", range(33, 65))
    assert chip_smoke.flash_bound(shape, False, "float32")[0] == pytest.approx(
        flops / 67e12 * 1e3)
    assert chip_smoke.flash_bound_basis((1, 4096, 8, 64), False, "float32")[
        "bound_basis"].startswith("3xTF32")
    monkeypatch.delattr(module, "runs_3xtf32")
    assert "fma_bound_ms" not in chip_smoke.flash_bound_basis((1, 4096, 8, 64), False, "float32")


def test_wide_rows_log_their_plan(capsys):
    """``chip_smoke.log_new_attention``'s line for a wide flash case names
    the cluster size and groups the launch ran beside the plan's, the slab
    width, the clusters the card held at once and whether two calls gave
    the same bits; a decode row keeps its splits."""
    flash = {"op": "flash", "shape": [2, 40, 3, 2304], "dtype": "bfloat16", "causal": True,
             "kernels": 1, "launches": 1, "max_abs_err": 0.0039, "tol": [0.02, 0.02],
             "bits_equal_twice": True, "plan": {"cluster": 6, "width": 128, "groups": 3},
             "launched": {"cluster": 6, "groups": 3, "active_clusters": 17},
             "max_abs_err_vs_tiled_plain": 0.002}
    decode = {"op": "decode", "shape": [2, 2, 300, 512], "pos": [150, 299], "dtype": "float32",
              "splits": 1, "kernels": 1, "launches": 1, "max_abs_err": 2e-7, "tol": 1e-5}
    chip_smoke.log_new_attention([], [flash, decode], [])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert ("cluster 6 (plan 6) x groups 3 (plan 3), slabs of <= 128 columns, 17 clusters at "
            "once; the same bits twice: True") in lines[0]
    assert "vs the tiled plain version 0.002" in lines[0]
    assert "splits 1 (1 kernels)" in lines[1]


def test_new_cases_record_every_held_case():
    """The kernels line's ``new_cases``: each integer case with its
    mismatches and each wide case with its error (4 significant digits),
    for the op asked, a row a case under its fields."""
    integer = [{"op": "flash", "dtype": "int8", "shape": [2, 300, 2, 16], "causal": True,
                "block_k": 48, "mismatches": 0},
               {"op": "decode", "dtype": "bool", "shape": [2, 2, 300, 16], "causal": None,
                "block_k": 16, "mismatches": 0}]
    wide = [{"op": "flash", "dtype": "float32", "shape": [1, 130, 2, 512], "causal": False,
             "max_abs_err": 1e-7},
            {"op": "decode", "dtype": "bfloat16", "shape": [2, 2, 300, 2048], "max_abs_err": 0.0}]
    cases = chip_smoke.new_cases("flash", integer, wide)
    assert cases["integer"] == {"fields": ["dtype", "shape", "causal", "block_k", "mismatches"],
                                "rows": [["int8", [2, 300, 2, 16], True, 48, 0]]}
    assert cases["wide"]["rows"] == [["float32", [1, 130, 2, 512], False, 1e-7]]
    decode = chip_smoke.new_cases("decode", integer, wide)
    assert [row[1][-1] for part in ("integer", "wide") for row in decode[part]["rows"]] == [
        16, 2048]
    # every dtype and block of the integer checks, and the widths past 256
    assert set(chip_smoke.INTEGER_ATTENTION) == {"bool", "int8", "uint8", "int16", "int32"}
    assert chip_smoke.INTEGER_BLOCKS == (128, 16, 48)
    assert chip_smoke.WIDE_HEAD_DIMS == (257, 300, 512, 576, 1024)
    # flash past one cluster group of the wide kernels: two groups, three
    assert chip_smoke.WIDEST_FLASH_DIMS == (2048, 2304)
