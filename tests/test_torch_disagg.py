"""``client_tpu_torch.disagg`` and the generate route's shared-memory inputs,
against ``client_tpu``.

- The route: a decode request carrying the KV as a shared-memory reference
  (``shared_memory_region`` / ``_byte_size`` / ``_offset`` and an explicit
  ``shape``) on ``/generate_stream``, sent to a JAX ``HttpInferenceServer``
  and to the port's (threaded and aio) over the same weights. The KV comes
  from ``decoder_lm_disagg_prefill`` written into a registered system shm
  region; the tokens must be equal, and the malformed references must get
  JAX's status codes and messages.
- ``DisaggClient`` / ``AioDisaggClient`` over port servers of the CPU zoo:
  the split stream equals ``tiny_lm_generate`` on one server; steady state
  creates no region and issues no registration RPC; ``END_ID``; tampered and
  corrupt handoffs raise ``HandoffCorrupt`` before any token; dedup and typed
  gaps; both role fallbacks with their ``RoleFallback`` events; the decode
  replica reset mid-stream (the port's ``ChaosProxy``) resumes through
  re-prefill with every index exactly once, and a lone decode replica kept
  dead raises ``DecodeAbandoned`` naming it; admission lanes; trace v5
  replay through ``PerfRunner(roles=...)``.
- Across packages: the port's ``DisaggClient`` against JAX servers gives the
  JAX client's tokens.
"""

import asyncio
import json
import uuid

import jax
import numpy as np
import pytest
import torch
import urllib3

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu import trace as jax_trace
from client_tpu.disagg import DisaggClient as JaxDisaggClient
from client_tpu.models import default_model_zoo as jax_zoo
from client_tpu.models.decoder import TinyDecoderModel as JaxDecoder
from client_tpu.models.disagg import DisaggPrefillModel as JaxDisaggPrefill
from client_tpu.models.disagg import KvDecodeModel as JaxKvDecode
from client_tpu.models.generate import TinyGenerateModel as JaxGenerate
from client_tpu.pool import EndpointSpec as JaxEndpointSpec
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch import trace as port_trace
from client_tpu_torch.admission import AdmissionController
from client_tpu_torch.disagg import (
    AioDisaggClient,
    DecodeAbandoned,
    DisaggClient,
    DisaggConfigError,
    HandoffCorrupt,
)
from client_tpu_torch.flight import FlightRecorder
from client_tpu_torch.models import default_model_zoo
from client_tpu_torch.models.decoder import TinyDecoderModel, load_jax_params
from client_tpu_torch.models.disagg import DisaggPrefillModel, KvDecodeModel
from client_tpu_torch.models.generate import TinyGenerateModel
from client_tpu_torch.observe import Telemetry
from client_tpu_torch.perf import PerfRunner
from client_tpu_torch.pool import EndpointSpec, PoolClient, RoleFallback
from client_tpu_torch.resilience import AttemptBudget
from client_tpu_torch.server import AioHttpInferenceServer, HttpInferenceServer, ServerCore
from client_tpu_torch.testing import ChaosProxy, Fault
from client_tpu_torch.utils import shared_memory as shm
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
MAX_TOKENS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_zoo_server():
    return HttpInferenceServer(ServerCore(default_model_zoo("cpu"), device="cpu")).start()


@pytest.fixture(scope="module")
def servers():
    svs = [_port_zoo_server() for _ in range(3)]
    yield svs
    for s in svs:
        s.stop()


@pytest.fixture(scope="module")
def monolithic(servers):
    """The reference stream: tiny_lm_generate on one replica."""
    pool = PoolClient([servers[0].url], protocol="http", health_interval_s=None)
    try:
        events = list(pool.generate_stream(
            "tiny_lm_generate", {"TOKENS": [PROMPT], "MAX_TOKENS": MAX_TOKENS}))
    finally:
        pool.close()
    return [int(e["NEXT_TOKEN"]) for e in events]


def _role_specs(servers):
    return [EndpointSpec(servers[0].url, role="prefill"),
            EndpointSpec(servers[1].url, role="decode")]


def _drain(stream):
    tokens, indices = [], []
    for event in stream:
        tokens.append(int(event["NEXT_TOKEN"]))
        indices.append(int(event["INDEX"]))
    return tokens, indices


# -- the generate route's shared-memory inputs ------------------------------------


@pytest.fixture(scope="module")
def route_servers():
    """One JAX server and the port's two HTTP frontends over the JAX
    decoder's weights: {name: url}."""
    jax_decoder = JaxDecoder(seed=0)
    jax_decoder._ensure_built()
    params = load_jax_params(jax.tree.map(np.asarray, jax_decoder._params), "cpu")
    decoder = TinyDecoderModel(device="cpu", params=params)
    port_core = ServerCore([decoder, TinyGenerateModel(decoder=decoder),
                            DisaggPrefillModel(decoder=decoder), KvDecodeModel(decoder=decoder)],
                           device="cpu")
    jax_core = JaxCore([jax_decoder, JaxGenerate(decoder=jax_decoder),
                        JaxDisaggPrefill(decoder=jax_decoder), JaxKvDecode(decoder=jax_decoder)])
    made = {"jax": JaxHttpServer(jax_core).start(),
            "port": HttpInferenceServer(port_core).start(),
            "port_aio": AioHttpInferenceServer(port_core).start()}
    yield {name: server.url for name, server in made.items()}
    for server in made.values():
        server.stop()


def _prefill_into_region(url, prompt):
    """decoder_lm_disagg_prefill with its KV written into a fresh system shm
    region registered on ``url``: (region, handle, kv shape, pos, token)."""
    client = port_http.InferenceServerClient(url)
    meta = client.get_model_metadata("decoder_lm_disagg_prefill")
    kv_shape = next(o["shape"] for o in meta["outputs"] if o["name"] == "KV")
    nbytes = int(np.prod(kv_shape)) * 4
    region = f"kv_{uuid.uuid4().hex[:8]}"
    handle = shm.create_shared_memory_region(region, "/" + region, nbytes)
    client.register_system_shared_memory(region, "/" + region, nbytes)
    inp = port_http.InferInput("TOKENS", [1, len(prompt)], "INT32")
    inp.set_data_from_numpy(np.array([prompt], np.int32))
    kv = port_http.InferRequestedOutput("KV").set_shared_memory(region, nbytes)
    res = client.infer("decoder_lm_disagg_prefill", [inp],
                       outputs=[kv, port_http.InferRequestedOutput("NEXT_TOKEN"),
                                port_http.InferRequestedOutput("POS")])
    pos = int(res.as_numpy("POS").reshape(-1)[0])
    token = int(res.as_numpy("NEXT_TOKEN").reshape(-1)[0])
    client.close()
    return region, handle, nbytes, kv_shape, pos, token


def _post_stream(url, payload):
    """(status, [events] or the error body) of a raw /generate_stream POST."""
    http = urllib3.PoolManager()
    resp = http.request("POST", f"http://{url}/v2/models/decoder_lm_kv_decode/generate_stream",
                        body=json.dumps(payload).encode(), headers={"Content-Type": "application/json"},
                        timeout=30.0)
    text = resp.data.decode()
    if resp.status != 200:
        return resp.status, json.loads(text)
    events = [json.loads(line[len("data: "):]) for line in text.splitlines()
              if line.startswith("data: ")]
    return resp.status, events


@pytest.fixture(scope="module")
def kv_regions(route_servers):
    made = {name: _prefill_into_region(url, PROMPT) for name, url in route_servers.items()}
    yield made
    for name, (region, handle, *_rest) in made.items():
        client = port_http.InferenceServerClient(route_servers[name])
        client.unregister_system_shared_memory(region)
        client.close()
        shm.destroy_shared_memory_region(handle)


def test_generate_route_takes_a_kv_reference(route_servers, kv_regions):
    streams = {}
    for name, url in route_servers.items():
        region, _, nbytes, kv_shape, pos, token = kv_regions[name]
        assert pos == len(PROMPT)
        status, events = _post_stream(url, {
            "KV": {"shared_memory_region": region, "shared_memory_byte_size": nbytes,
                   "shared_memory_offset": 0, "shape": kv_shape},
            "POS": pos, "FIRST_TOKEN": token, "MAX_TOKENS": 8})
        assert status == 200, events
        assert [e["INDEX"] for e in events] == list(range(8)), events
        streams[name] = [token] + [e["NEXT_TOKEN"] for e in events]
    assert streams["port"] == streams["port_aio"] == streams["jax"]


MALFORMED = {
    "no_region": {"shared_memory_byte_size": 16, "shape": [1]},
    "no_shape": {"shared_memory_region": "kv"},
    "empty_shape": {"shared_memory_region": "kv", "shape": []},
    "negative_dim": {"shared_memory_region": "kv", "shape": [2, -1]},
    "bool_dim": {"shared_memory_region": "kv", "shape": [True, 2]},
    "shape_not_a_list": {"shared_memory_region": "kv", "shape": "2,2"},
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_generate_route_refuses_a_malformed_reference(route_servers, case):
    answers = {name: _post_stream(url, {"KV": MALFORMED[case], "POS": 1, "FIRST_TOKEN": 0})
               for name, url in route_servers.items()}
    assert answers["jax"][0] == 400
    assert answers["port"] == answers["port_aio"] == answers["jax"]
    assert "generate input 'KV'" in answers["port"][1]["error"]


# -- the split stream ----------------------------------------------------------------


def test_disagg_equals_monolithic_and_steady_state_zero_rpcs(servers, monolithic):
    client = DisaggClient(_role_specs(servers), protocol="http", health_interval_s=None)
    try:
        tokens, indices = _drain(client.generate_stream(PROMPT, max_tokens=MAX_TOKENS))
        assert tokens == monolithic
        assert indices == list(range(MAX_TOKENS))
        before = client.arena().stats()
        for _ in range(3):
            tokens, _ = _drain(client.generate_stream(PROMPT, max_tokens=MAX_TOKENS))
            assert tokens == monolithic
        after = client.arena().stats()
        assert after["regions_created"] == before["regions_created"]
        assert after["registrations_issued"] == before["registrations_issued"]
        assert after["leased_bytes"] == 0
        assert client.arena().default_family == "system"
    finally:
        client.close()


def test_disagg_equals_monolithic_aio(servers, monolithic):
    async def go():
        client = AioDisaggClient(_role_specs(servers), protocol="http", health_interval_s=None)
        try:
            tokens, indices = [], []
            async for event in client.generate_stream(PROMPT, max_tokens=MAX_TOKENS):
                tokens.append(int(event["NEXT_TOKEN"]))
                indices.append(int(event["INDEX"]))
            return tokens, indices
        finally:
            await client.close()

    tokens, indices = asyncio.run(go())
    assert tokens == monolithic
    assert indices == list(range(MAX_TOKENS))


def test_end_id_stops_the_stream(servers, monolithic):
    end_id = monolithic[3]
    stop = monolithic.index(end_id)
    client = DisaggClient(_role_specs(servers), protocol="http", health_interval_s=None)
    try:
        tokens, _ = _drain(client.generate_stream(PROMPT, max_tokens=MAX_TOKENS, end_id=end_id))
        assert tokens == monolithic[:stop + 1]  # stops ON the end token
    finally:
        client.close()


def test_tampered_handoff_raises_typed_corrupt(servers):
    client = DisaggClient(_role_specs(servers), protocol="http", health_interval_s=None)
    try:
        budget = AttemptBudget(client.inner._budget_policy, None)
        handoff = client._prefill_leg(PROMPT, budget, 0, "")
        try:
            handoff.verify("ok")
            view = handoff.lease.memoryview()
            view[7] = (view[7] + 1) % 256
            with pytest.raises(HandoffCorrupt) as ei:
                handoff.verify("127.0.0.1:1")
            assert ei.value.field == "digest"
            assert "127.0.0.1:1" in str(ei.value)
        finally:
            handoff.release()
            handoff.release()  # idempotent
        assert client.arena().stats()["leased_bytes"] == 0
    finally:
        client.close()


@pytest.mark.parametrize("aio", [False, True], ids=["sync", "aio"])
def test_corrupt_handoff_never_streams_tokens(servers, aio):
    cls = AioDisaggClient if aio else DisaggClient
    real_leg = cls._prefill_leg

    def tamper(handoff):
        view = handoff.lease.memoryview()
        view[0] = (view[0] + 1) % 256
        return handoff

    if aio:
        async def leg(self, *args):
            return tamper(await real_leg(self, *args))

        async def go():
            client = cls(_role_specs(servers), protocol="http", health_interval_s=None)
            client._prefill_leg = leg.__get__(client)
            emitted = []
            try:
                with pytest.raises(HandoffCorrupt):
                    async for event in client.generate_stream(PROMPT, max_tokens=4):
                        emitted.append(event)
                return emitted, client.arena().stats()["leased_bytes"]
            finally:
                await client.close()

        emitted, leased = asyncio.run(go())
    else:
        def leg(self, *args):
            return tamper(real_leg(self, *args))

        client = cls(_role_specs(servers), protocol="http", health_interval_s=None)
        client._prefill_leg = leg.__get__(client)
        emitted = []
        try:
            with pytest.raises(HandoffCorrupt):
                for event in client.generate_stream(PROMPT, max_tokens=4):
                    emitted.append(event)
            leased = client.arena().stats()["leased_bytes"]
        finally:
            client.close()
    assert emitted == []
    assert leased == 0


def test_accept_event_dedups_and_types_gaps(servers):
    client = DisaggClient(_role_specs(servers), protocol="http", health_interval_s=None)
    try:
        emitted = [7, 8]
        assert client._accept_event({"NEXT_TOKEN": 8, "INDEX": 1}, emitted, "u") is None
        assert emitted == [7, 8]
        with pytest.raises(HandoffCorrupt) as ei:
            client._accept_event({"NEXT_TOKEN": 9, "INDEX": 0}, emitted, "u")
        assert ei.value.field == "token"
        with pytest.raises(HandoffCorrupt) as ei:
            client._accept_event({"NEXT_TOKEN": 1, "INDEX": 5}, emitted, "u")
        assert ei.value.field == "index"
        assert client._accept_event({"NEXT_TOKEN": 4, "INDEX": 2}, emitted, "u") == (4, 2)
        assert emitted == [7, 8, 4]
    finally:
        client.close()


@pytest.mark.parametrize("present, missing", [("prefill", "decode"), ("decode", "prefill")])
def test_missing_role_falls_back_typed(servers, monolithic, present, missing):
    events = []
    url = servers[0].url if present == "prefill" else servers[1].url
    client = DisaggClient([EndpointSpec(url, role=present)], protocol="http",
                          health_interval_s=None, on_event=events.append)
    try:
        tokens, indices = _drain(client.generate_stream(PROMPT, max_tokens=MAX_TOKENS))
        assert tokens == monolithic  # degraded, not different
        assert indices == list(range(MAX_TOKENS))
        falls = [e for e in events if isinstance(e, RoleFallback)]
        assert [(f.role, f.reason) for f in falls] == [(missing, "unavailable")]
        assert client.inner.pool.role_fallbacks == {missing: 1}
        assert client.inner.health_summary()["roles"][present]["available"] is True
        assert client.arena().stats()["leased_bytes"] == 0
    finally:
        client.close()


def test_config_errors_are_typed(servers):
    url = servers[0].url
    with pytest.raises(DisaggConfigError, match="substrate"):
        DisaggClient(port_http.InferenceServerClient(url))
    with pytest.raises(DisaggConfigError, match="shm_arena"):
        DisaggClient([url], protocol="http", shm_arena=None, health_interval_s=None)
    pool = PoolClient([url], protocol="http", shm_arena=True, health_interval_s=None)
    try:
        with pytest.raises(DisaggConfigError, match="pool kwargs"):
            DisaggClient(pool, health_interval_s=None)
        with pytest.raises(DisaggConfigError, match="sync/aio"):
            AioDisaggClient(pool)
    finally:
        pool.close()


def test_empty_prompt_and_bad_max_tokens_rejected(servers):
    client = DisaggClient(_role_specs(servers), protocol="http", health_interval_s=None)
    try:
        with pytest.raises(Exception, match="empty prompt"):
            client.generate_stream([])
        with pytest.raises(Exception, match="max_tokens"):
            client.generate_stream(PROMPT, max_tokens=0)
    finally:
        client.close()


# -- recovery -----------------------------------------------------------------------


def test_decode_killed_mid_stream_recovers_exactly_once(servers, monolithic):
    """The decode replica behind a proxy is reset after the fourth token; the
    session finishes on the other decode replica through re-prefill, every
    index exactly once, and the flight recorder keeps the causal chain."""
    proxy = ChaosProxy("127.0.0.1", servers[1].port).start()
    tel = Telemetry(flight=FlightRecorder(baseline_ratio=1.0))
    client = DisaggClient(
        [EndpointSpec(servers[0].url, role="prefill"), EndpointSpec(proxy.url, role="decode"),
         EndpointSpec(servers[2].url, role="decode")],
        protocol="http", health_interval_s=None, routing="round_robin", telemetry=tel)
    kills = 0
    try:
        for _ in range(6):
            conns = proxy.stats["connections"]
            tokens, indices, killed = [], [], False
            for event in client.generate_stream(PROMPT, max_tokens=MAX_TOKENS):
                tokens.append(int(event["NEXT_TOKEN"]))
                indices.append(int(event["INDEX"]))
                if not killed and len(tokens) == 4 and proxy.stats["connections"] > conns:
                    proxy.fault = Fault("reset", after_bytes=0)
                    proxy.reset_active()
                    killed = True
            if killed:
                kills += 1
                proxy.heal()
            assert tokens == monolithic
            assert indices == list(range(MAX_TOKENS))
            if kills:
                break
        assert kills == 1, "no session ran on the proxied decode replica"
        names = {(e[1], e[2]) for t in tel.flight.retained() for e in t.events}
        for event in ("decode_died", "reprefill", "handoff", "verify"):
            assert ("disagg", event) in names, event
        assert client.arena().stats()["leased_bytes"] == 0
    finally:
        client.close()
        proxy.stop()


def test_unrecoverable_decode_death_names_the_replica(servers):
    proxy = ChaosProxy("127.0.0.1", servers[1].port).start()
    client = DisaggClient(
        [EndpointSpec(servers[0].url, role="prefill"), EndpointSpec(proxy.url, role="decode")],
        protocol="http", health_interval_s=None)
    try:
        got = []
        with pytest.raises(DecodeAbandoned) as ei:
            for event in client.generate_stream(PROMPT, max_tokens=MAX_TOKENS):
                got.append(int(event["NEXT_TOKEN"]))
                if len(got) == 3:
                    proxy.fault = Fault("reset", after_bytes=0)
                    proxy.reset_active()
        assert ei.value.url == proxy.url
        assert ei.value.emitted == len(got) >= 3
        assert proxy.url in str(ei.value)
        assert client.arena().stats()["leased_bytes"] == 0
    finally:
        client.close()
        proxy.stop()


# -- admission and replay -------------------------------------------------------------


def test_admission_charges_separate_lanes(servers):
    ctrl = AdmissionController()
    client = DisaggClient(_role_specs(servers), protocol="http", health_interval_s=None,
                          admission=ctrl)
    try:
        _drain(client.generate_stream(PROMPT, max_tokens=4))
        lanes = ctrl.snapshot()["lanes"]
        assert lanes["disagg:prefill"]["admitted_total"] == 1
        assert lanes["disagg:decode"]["admitted_total"] == 1
    finally:
        client.close()


SPEC_V5 = ("mixed:duration_s=2,rate=12,stream_fraction=0.1,seq_fraction=0,"
           "disagg_fraction=0.5,max_prompt=20,max_output=6,unary_model=simple")


def test_trace_v5_is_the_jax_trace():
    ours, theirs = port_trace.generate(SPEC_V5, seed=11), jax_trace.generate(SPEC_V5, seed=11)
    assert port_trace.dumps_trace(ours.records, ours.header) == \
        jax_trace.dumps_trace(theirs.records, theirs.header)
    assert ours.kind_counts()["prefill_decode"] > 0


def test_replay_drives_disagg_sessions(servers):
    u0, u1 = servers[0].url, servers[1].url
    tr = port_trace.generate(SPEC_V5, seed=11)
    n_disagg = tr.kind_counts()["prefill_decode"]
    assert n_disagg > 0
    runner = PerfRunner(u0, "http", "simple", endpoints=[u0, u1],
                        roles=f"prefill={u0};decode={u1}", device="cpu")
    try:
        res = runner.run_trace(tr, speed=4.0, replay_workers=8)
    finally:
        runner.close()
    assert res["errors"] == 0, res["error_sample"]
    assert res["kinds"]["prefill_decode"]["ok"] == n_disagg


def test_replay_without_roles_is_typed(servers):
    tr = port_trace.generate("mixed:duration_s=1,rate=10,disagg_fraction=0.5", seed=3)
    runner = PerfRunner(servers[0].url, "http", "simple", device="cpu")
    try:
        with pytest.raises(ValueError, match="--roles"):
            runner.run_trace(tr, speed=4.0)
    finally:
        runner.close()


# -- across packages --------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_servers():
    svs = [JaxHttpServer(JaxCore(jax_zoo())).start() for _ in range(2)]
    yield svs
    for s in svs:
        s.stop()


def test_port_client_on_jax_servers_gives_the_jax_client_s_tokens(jax_servers):
    u0, u1 = (f"127.0.0.1:{s.port}" for s in jax_servers)
    theirs_client = JaxDisaggClient([JaxEndpointSpec(u0, role="prefill"),
                                     JaxEndpointSpec(u1, role="decode")],
                                    protocol="http", health_interval_s=None)
    ours_client = DisaggClient([EndpointSpec(u0, role="prefill"), EndpointSpec(u1, role="decode")],
                               protocol="http", health_interval_s=None)
    try:
        theirs = _drain(theirs_client.generate_stream(PROMPT, max_tokens=MAX_TOKENS))
        ours = _drain(ours_client.generate_stream(PROMPT, max_tokens=MAX_TOKENS))
    finally:
        theirs_client.close()
        ours_client.close()
    assert ours == theirs
    mono = jax_http.InferenceServerClient(u0)
    try:
        events = list(mono.generate_stream("tiny_lm_generate",
                                           {"TOKENS": [PROMPT], "MAX_TOKENS": MAX_TOKENS}))
    finally:
        mono.close()
    assert ours[0] == [int(e["NEXT_TOKEN"]) for e in events]
