"""``client_tpu_torch.arena`` against ``client_tpu.arena``.

The cases of ``tests/test_arena.py``, run on both packages with the same
operations: the port's device family is ``"cuda"`` (regions of
``utils.cuda_shared_memory`` on the CPU here, ``device="cpu"``) where the JAX
package's is ``"tpu"``. Each scenario returns what it observed — stats,
registration counts, the errors raised (``ArenaError``,
``ArenaLeaseReleased``, integrity ``digest`` violations) — and the two
packages must observe the same. Then the clients: ``configure_arena`` on the
four port clients (HTTP and GRPC, sync and aio) against both packages'
servers, with the promotion fast path, output leases, registration caching
and ``IntegrityPolicy(digests=True)`` catching a slab scribbled after the
answer.
"""

import asyncio
import threading

import jax
import numpy as np
import pytest
import torch

import client_tpu.grpc as jax_grpc
import client_tpu.grpc.aio as jax_grpc_aio
import client_tpu.http as jax_http
import client_tpu.http.aio as jax_http_aio
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.grpc.aio as port_grpc_aio
import client_tpu_torch.http as port_http
import client_tpu_torch.http.aio as port_http_aio
from client_tpu import arena as jax_arena
from client_tpu import integrity as jax_integrity
from client_tpu import observe as jax_observe
from client_tpu._tensor import InferInput as JaxInferInput
from client_tpu._tensor import InferRequestedOutput as JaxRequestedOutput
from client_tpu.models import simple as jax_simple
from client_tpu.server import GrpcInferenceServer as JaxGrpcServer
from client_tpu.server import HttpInferenceServer as JaxHttpServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch import arena as port_arena
from client_tpu_torch import integrity as port_integrity
from client_tpu_torch import observe as port_observe
from client_tpu_torch._tensor import InferInput as PortInferInput
from client_tpu_torch._tensor import InferRequestedOutput as PortRequestedOutput
from client_tpu_torch.models import AddSubModel, IdentityModel
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

ARENA = {"jax": jax_arena, "port": port_arena}
INTEGRITY = {"jax": jax_integrity, "port": port_integrity}
OBSERVE = {"jax": jax_observe, "port": port_observe}
TENSORS = {"jax": (JaxInferInput, JaxRequestedOutput),
           "port": (PortInferInput, PortRequestedOutput)}
# the device family of each package
DEVICE_FAMILY = {"jax": "tpu", "port": "cuda"}
FAMILIES = ("system", "device")


def _family(pkg, family):
    return DEVICE_FAMILY[pkg] if family == "device" else family


def _make_arena(pkg, family="system", **kwargs):
    kwargs["default_family"] = _family(pkg, family)
    if pkg == "port":
        kwargs["device"] = "cpu"  # CPU cuda regions on this host
    return ARENA[pkg].ShmArena(**kwargs)


def _write_device(pkg, lease, x):
    if pkg == "jax":
        dev = jax.device_put(x)
        dev.block_until_ready()
        return lease.write_jax(dev)
    return lease.write_torch(torch.from_numpy(x.copy()))


def _read_device(pkg, lease, datatype, shape):
    if pkg == "jax":
        return np.asarray(lease.as_jax(datatype, shape))
    return lease.as_torch(datatype, shape, device="cpu").numpy()


def _error(fn):
    """The arena error ``fn`` raises, by class name (None if it returns)."""
    try:
        fn()
    except (jax_arena.ArenaError, port_arena.ArenaError) as e:
        return type(e).__name__
    return None


def _stats(arena):
    return {k: v for k, v in arena.stats().items()}


def _inventory(arena, pkg):
    return [{k: (DEVICE_FAMILY["jax"] if v == DEVICE_FAMILY[pkg] else v)
             for k, v in row.items() if k not in ("name", "key")}
            for row in arena.inventory()]


# -- allocation and lease semantics, the same ops on both packages ------------
def scenario_size_classes(pkg, family):
    a = _make_arena(pkg, family)
    try:
        f = _family(pkg, family)
        leases = [a.lease(100, f), a.lease(4097, f), a.lease(5 * 1024, f)]
        out = [[lease.byte_size for lease in leases], _stats(a), _inventory(a, pkg)]
        for lease in leases:
            lease.release()
        out.append(_stats(a))
        return out
    finally:
        a.close(force=True)


def scenario_oversize(pkg, family):
    a = _make_arena(pkg, family)
    try:
        big = a.lease(a.max_class_bytes + 1)
        out = [big.byte_size, big.byte_size % 4096, _stats(a)]
        big.release()
        return out
    finally:
        a.close(force=True)


def scenario_double_release(pkg, family):
    a = _make_arena(pkg, family)
    try:
        lease = a.lease(64)
        lease.retain()
        lease.release()
        out = [lease.released]
        lease.release()
        out += [lease.released, _error(lease.release), _error(lease.retain), _stats(a)]
        return out
    finally:
        a.close(force=True)


def scenario_view_after_release(pkg, family):
    a = _make_arena(pkg, family)
    try:
        lease = a.lease(1024)
        lease.write_numpy(np.arange(256, dtype=np.float32))
        view = lease.as_numpy("FP32", [256])
        out = [float(view[7])]
        lease.release()
        out += [_error(lambda: lease.as_numpy("FP32", [256])),
                _error(lease.memoryview), _error(lambda: lease.write(b"x"))]
        return out
    finally:
        a.close(force=True)


def scenario_zero_copy(pkg, family):
    a = _make_arena(pkg, family)
    try:
        lease = a.lease(1024)
        lease.write_numpy(np.zeros(256, dtype=np.float32))
        view = lease.as_numpy("FP32", [256])
        lease.write_numpy(np.full(256, 3.0, dtype=np.float32))
        out = [float(view[0]), lease.nbytes]
        lease.release()
        return out
    finally:
        a.close(force=True)


def scenario_bounds(pkg, family):
    a = _make_arena(pkg, family)
    try:
        lease = a.lease(100)
        out = [_error(lambda: lease.write(b"x" * (lease.byte_size + 1))),
               _error(lambda: lease.as_numpy("FP32", [4096])),
               _error(lambda: a.lease(0)), _error(lambda: a.lease(8, family="nope"))]
        lease.release()
        return out
    finally:
        a.close(force=True)


def scenario_lru_trim(pkg, family):
    a = _make_arena(pkg, family, region_target_bytes=4096,
                    high_watermark_bytes=2 * 4096, low_watermark_bytes=4096)
    try:
        leases = [a.lease(4096) for _ in range(3)]
        out = [_stats(a)["regions"]]
        for lease in leases:
            lease.release()
        # the trim runs on a short-lived thread: wait for its destroys
        for t in [t for t in threading.enumerate() if t.name == "shm-arena-trim"]:
            t.join(timeout=10)
        out.append(_stats(a))
        out.append(a.trim(0))
        out.append(_stats(a))
        return out
    finally:
        a.close(force=True)


def scenario_close(pkg, family):
    a = _make_arena(pkg, family)
    lease = a.lease(64)
    out = [_error(a.close)]
    lease.release()
    out += [_error(a.close), _error(lambda: a.lease(64)), _stats(a)]
    return out


def scenario_rebind(pkg, family):
    a = _make_arena(pkg, family)
    try:
        in_cls, out_cls = TENSORS[pkg]
        lease = a.lease(64)
        inp = in_cls("X", [16], "INT32")
        lease.bind_input(inp)
        lease.bind_input(inp)
        olease = a.lease(64)
        out = out_cls("Y")
        olease.bind_output(out)
        olease.bind_output(out)
        seen = [lease.released, inp._arena_lease is lease, olease.released,
                out._arena_lease is olease, inp._get_tensor_json(), out._get_tensor_json()]
        # re-staging the input releases its lease; releasing twice is a no-op
        inp.set_data_from_numpy(np.arange(16, dtype=np.int32))
        inp.release_arena_lease()
        out.release_arena_lease()
        out.release_arena_lease()
        return [seen[:4], [lease.released, olease.released], _stats(a)]
    finally:
        a.close(force=True)


def scenario_stage_and_request_output(pkg, family):
    a = _make_arena(pkg, family)
    try:
        lease = a.stage(b"abcdefgh" * 100)
        out = a.request_output("OUT", 4000)
        seen = [lease.nbytes, lease.byte_size, bytes(lease.memoryview()[:8]),
                out._get_tensor_json()["parameters"]["shared_memory_byte_size"],
                _stats(a)["leases"]]
        lease.release()
        out.release_arena_lease()
        seen.append(_stats(a)["leased_bytes"])
        return seen
    finally:
        a.close(force=True)


def scenario_typed_views(pkg, family):
    """BYTES and BF16 payloads through ``write_numpy`` and ``as_numpy``."""
    a = _make_arena(pkg, family)
    try:
        words = np.array([b"one", b"three", b""], dtype=np.object_)
        lease = a.lease(64)
        n = lease.write_numpy(words)
        got = lease.as_numpy("BYTES", [3])
        bf16 = np.arange(8, dtype=np.float32).astype(jax.numpy.bfloat16)
        l2 = a.lease(64)
        n2 = l2.write_numpy(bf16)
        got2 = l2.as_numpy("BF16", [8]).astype(np.float32)
        lease.release()
        l2.release()
        return [n, [bytes(w) for w in got], n2, got2.tolist()]
    finally:
        a.close(force=True)


def scenario_digest(pkg, family):
    a = _make_arena(pkg, family)
    try:
        lease = a.lease(1024)
        lease.write_numpy(np.arange(256, dtype=np.float32))
        seal = lease.seal_digest()
        seen = [seal.nbytes, len(seal.hexdigest), lease.digest() is seal,
                float(lease.as_numpy("FP32", [256])[5])]
        # a local write drops the seal (the holder mutating its own slab)
        lease.write_numpy(np.ones(256, dtype=np.float32))
        seen.append(lease.digest() is None)
        lease.seal_digest()
        # a scribble after the answer: a byte changed behind the lease
        view = lease._region._host_view()
        view[lease.offset] ^= 0xFF
        try:
            lease.as_numpy("FP32", [256])
            seen.append(None)
        except (jax_integrity.IntegrityError, port_integrity.IntegrityError) as e:
            seen.append((type(e).__name__, e.kind))
        lease.release()
        return seen
    finally:
        a.close(force=True)


def scenario_registration_bookkeeping(pkg, family):
    """The registration cache with a fake client: one RPC a region an
    endpoint, cached after; a server-side unregister and an endpoint
    invalidation drop the entries."""
    calls = []

    class Client:
        _url = "127.0.0.1:1"

        def register_system_shared_memory(self, *args):
            calls.append("system")

        def register_tpu_shared_memory(self, *args):
            calls.append("device")

        register_cuda_shared_memory = register_tpu_shared_memory

    a = _make_arena(pkg, family)
    try:
        client = Client()
        l1, l2 = a.lease(64), a.lease(64 * 1024)
        seen = [a.ensure_registered(client, l1._region),
                a.ensure_registered(client, l1._region),
                a.ensure_registered(client, l2._region),
                a.is_registered(client, l1.region_name)]
        ARENA[pkg].notify_unregister(client._url, l1.region_name)
        seen += [a.is_registered(client, l1.region_name),
                 a.ensure_registered(client, l1._region),
                 a.invalidate_endpoint(client._url),
                 a.registration_entries(), list(calls)]
        l1.release()
        l2.release()
        stats = _stats(a)
        seen.append({k: stats[k] for k in stats if k.startswith("registration")})
        return seen
    finally:
        a.close(force=True)


def scenario_device_roundtrip(pkg, family):
    if family != "device":
        return "device family only"
    a = _make_arena(pkg, family, colocated=True)
    try:
        x = np.arange(16, dtype=np.float32).reshape(1, 16)
        lease = a.lease(x.nbytes)
        n = _write_device(pkg, lease, x)
        back = _read_device(pkg, lease, "FP32", [1, 16])
        host = lease.as_numpy("FP32", [1, 16]).copy()
        lease.release()
        return [n, back.tolist(), host.tolist(), _stats(a)["leased_bytes"]]
    finally:
        a.close(force=True)


def scenario_device_slab_reuse(pkg, family):
    """A freed slab that held a pinned device tensor serves fresh host bytes
    to its next occupant; a host write after a device write on the same
    lease wins."""
    if family != "device":
        return "device family only"
    a = _make_arena(pkg, family, colocated=True)
    try:
        x = np.full((1, 16), 7.0, dtype=np.float32)
        y = np.full((1, 16), 3.0, dtype=np.float32)
        l1 = a.lease(x.nbytes)
        _write_device(pkg, l1, x)
        l1.release()
        l2 = a.lease(y.nbytes)
        same = (l2.region_key, l2.offset) == (l1.region_key, l1.offset)
        l2.write_numpy(y)
        first = l2.as_numpy("FP32", [1, 16]).tolist()
        _write_device(pkg, l2, x)
        l2.write_numpy(y)
        second = l2.as_numpy("FP32", [1, 16]).tolist()
        l2.release()
        return [same, first, second]
    finally:
        a.close(force=True)


def scenario_wrong_family_device_calls(pkg, family):
    if family != "system":
        return "system family only"
    a = _make_arena(pkg, family)
    try:
        lease = a.lease(64)
        x = np.zeros(4, dtype=np.float32)
        out = [_error(lambda: _write_device(pkg, lease, x)),
               _error(lambda: _read_device(pkg, lease, "FP32", [4]))]
        lease.release()
        return out
    finally:
        a.close(force=True)


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_ops_same_observations(scenario, family):
    fn = SCENARIOS[scenario]
    assert fn("port", family) == fn("jax", family)


def test_port_device_family_is_cuda():
    a = _make_arena("port", "device")
    try:
        lease = a.lease(64)
        assert lease.family == "cuda"
        assert isinstance(lease._region.handle, cudashm.CudaSharedMemoryRegion)
        assert a.inventory()[0]["family"] == "cuda"
        lease.release()
        with pytest.raises(port_arena.ArenaError):
            port_arena.ShmArena(default_family="tpu")
    finally:
        a.close(force=True)


def test_as_torch_is_the_leased_tensor_in_process():
    """Colocated: the tensor bound with ``write_torch`` comes back itself
    (no copy), and the host window is left untouched."""
    a = _make_arena("port", "device", colocated=True)
    try:
        lease = a.lease(64)
        x = torch.arange(16, dtype=torch.float32)
        lease.write_torch(x)
        assert lease.as_torch("FP32", [16], device="cpu").data_ptr() == x.data_ptr()
        assert not any(lease._region.handle.host_buffer()[lease.offset:lease.offset + 64])
        lease.release()
    finally:
        a.close(force=True)


# -- concurrency stress ---------------------------------------------------------
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_thread_stress_no_double_lease_and_residency_zero(pkg):
    recorder = OBSERVE[pkg].enable_dataplane()
    a = _make_arena(pkg, "device")
    errors = []
    live_lock = threading.Lock()
    live = set()

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(100):
                lease = a.lease(int(rng.integers(1, 32 * 1024)))
                slot = (lease.region_key, lease.offset)
                with live_lock:
                    assert slot not in live, "double-leased slab"
                    live.add(slot)
                lease.write(b"x" * min(lease.nbytes, 64))
                with live_lock:
                    live.remove(slot)
                lease.release()
        except BaseException as e:  # pragma: no cover - failure path
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        s = a.stats()
        assert s["leases"] == 8 * 100 == s["releases"]
        assert s["leased_bytes"] == 0 and s["leased_slabs"] == 0
        snap = recorder.snapshot()["arena"]
        assert snap["leases"]
        assert all(row["leased"] == 0 for row in snap["bytes"].values())
    finally:
        OBSERVE[pkg].install_dataplane(None)
        a.close(force=True)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_asyncio_stress_residency_zero(pkg):
    a = _make_arena(pkg, "device")

    async def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(50):
            lease = a.lease(int(rng.integers(1, 16 * 1024)))
            await asyncio.sleep(0)
            lease.retain()
            lease.release()
            await asyncio.sleep(0)
            lease.release()

    async def main():
        await asyncio.gather(*(worker(i) for i in range(16)))

    try:
        asyncio.run(main())
        s = a.stats()
        assert s["leased_bytes"] == 0 and s["leased_slabs"] == 0
        assert s["leases"] == 16 * 50
    finally:
        a.close(force=True)


# -- the clients: configure_arena on the 2x2 client/server matrix -------------
def _port_models():
    return [AddSubModel(device="cpu"), IdentityModel("identity_fp32", "FP32", device="cpu")]


def _jax_models():
    return [jax_simple.AddSubModel(), jax_simple.IdentityModel("identity_fp32", "FP32")]


@pytest.fixture(scope="module")
def servers():
    port_core = ServerCore(_port_models(), device="cpu")
    jax_core = JaxCore(_jax_models())
    made = {("port", "http"): HttpInferenceServer(port_core).start(),
            ("port", "grpc"): GrpcInferenceServer(port_core).start(),
            ("jax", "http"): JaxHttpServer(jax_core).start(),
            ("jax", "grpc"): JaxGrpcServer(jax_core).start()}
    yield made
    for server in made.values():
        server.stop()


CLIENTS = {
    "http": (port_http, jax_http, "http", False),
    "grpc": (port_grpc, jax_grpc, "grpc", False),
    "http_aio": (port_http_aio, jax_http_aio, "http", True),
    "grpc_aio": (port_grpc_aio, jax_grpc_aio, "grpc", True),
}


def _pair():
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    return a, np.ones((1, 16), dtype=np.int32)


def _drive(mod, is_aio, url, arena, rounds, policy=None):
    """``rounds`` simple requests with promoted inputs and OUTPUT0 in an
    output lease; what the caller saw, per round."""
    a, b = _pair()

    def request():
        in0 = mod.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a)
        in1 = mod.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)
        out0 = arena.request_output("OUTPUT0", a.nbytes)
        out1 = mod.InferRequestedOutput("OUTPUT1")
        return [in0, in1], [out0, out1]

    def read(result, inputs, outputs):
        o0 = result.as_numpy("OUTPUT0").copy()
        o1 = result.as_numpy("OUTPUT1")
        restored = inputs[0]._raw_data is not None
        result.release_arena()
        outputs[0].release_arena_lease()
        try:
            result.as_numpy("OUTPUT0")
            after = None
        except (jax_arena.ArenaLeaseReleased, port_arena.ArenaLeaseReleased) as e:
            after = type(e).__name__
        return (o0 == a + b).all() and (o1 == a - b).all(), restored, after

    if not is_aio:
        client = mod.InferenceServerClient(url)
        try:
            client.configure_arena(arena)
            if policy is not None:
                client.configure_integrity(policy)
            seen = []
            for _ in range(rounds):
                inputs, outputs = request()
                seen.append(read(client.infer("simple", inputs, outputs=outputs),
                                 inputs, outputs))
            return seen
        finally:
            client.close()

    async def main():
        client = mod.InferenceServerClient(url)
        try:
            client.configure_arena(arena)
            if policy is not None:
                client.configure_integrity(policy)
            seen = []
            for _ in range(rounds):
                inputs, outputs = request()
                result = await client.infer("simple", inputs, outputs=outputs)
                seen.append(read(result, inputs, outputs))
            return seen
        finally:
            await client.close()

    return asyncio.run(main())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_configure_arena_matrix(servers, client, server, family):
    """The port client against either server, beside the JAX client with
    its own arena against the JAX server (the JAX package's tpu family has
    no route on the port's GRPC server): the same outputs, promotion
    releasing every transient lease, one registration a region, cache hits
    after."""
    port_mod, jax_mod, protocol, is_aio = CLIENTS[client]
    rows = {}
    for pkg, mod in (("port", port_mod), ("jax", jax_mod)):
        url = servers[(server if pkg == "port" else "jax", protocol)].url
        arena = _make_arena(pkg, family)
        try:
            seen = _drive(mod, is_aio, url, arena, rounds=3)
            stats = arena.stats()
            rows[pkg] = (seen, {k: stats[k] for k in (
                "leases", "hits", "misses", "regions_created", "registrations_issued",
                "registrations_cached", "leased_bytes", "leased_slabs", "regions")})
        finally:
            arena.close(force=True)
    assert rows["port"] == rows["jax"]
    seen, stats = rows["port"]
    assert seen == [(True, True, "ArenaLeaseReleased")] * 3
    assert stats["leased_bytes"] == 0 and stats["registrations_issued"] == stats["regions"]


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["http", "grpc"])
def test_unregister_invalidates_the_cache(servers, client, server):
    port_mod, jax_mod, protocol, _ = CLIENTS[client]
    url = servers[(server, protocol)].url
    counts = {}
    for pkg, mod in (("port", port_mod), ("jax", jax_mod)):
        arena = _make_arena(pkg, "system")
        c = mod.InferenceServerClient(url)
        try:
            l1, l2 = arena.lease(4096), arena.lease(64 * 1024)
            seen = [arena.ensure_registered(c, l1._region),
                    arena.ensure_registered(c, l1._region),
                    arena.ensure_registered(c, l2._region)]
            c.unregister_system_shared_memory(l1.region_name)
            seen.append(arena.stats()["registrations_invalidated"])
            seen.append(arena.ensure_registered(c, l1._region))
            c.unregister_system_shared_memory()  # "" = every region
            seen.append(arena.registration_entries())
            l1.release()
            l2.release()
            counts[pkg] = seen
        finally:
            c.close()
            arena.close(force=True)
    assert counts["port"] == counts["jax"] == [True, False, True, 1, True, {}]


def test_default_arena_via_true(servers):
    a, b = _pair()
    with port_http.InferenceServerClient(servers[("port", "http")].url) as client:
        client.configure_arena(True)
        assert client.arena() is port_arena.default_arena()
        in0 = port_http.InferInput("INPUT0", [1, 16], "INT32").set_data_from_numpy(a)
        in1 = port_http.InferInput("INPUT1", [1, 16], "INT32").set_data_from_numpy(b)
        result = client.infer("simple", [in0, in1])
        np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), a + b)
        assert port_arena.default_arena().stats()["leased_bytes"] == 0
        client.configure_arena(None)
        assert client.arena() is None


@pytest.mark.parametrize("server", ["port", "jax"])
def test_explicit_staging_and_released_lease_refuses_to_bind(servers, server):
    url = servers[(server, "http")].url
    a, b = _pair()
    arena = _make_arena("port", "device")
    try:
        with port_http.InferenceServerClient(url) as client:
            inputs = [port_http.InferInput(n, [1, 16], "INT32").set_data_from_numpy(x, arena=arena)
                      for n, x in (("INPUT0", a), ("INPUT1", b))]
            assert inputs[0]._arena_lease is not None and inputs[0]._raw_data is None
            out0 = arena.request_output("OUTPUT0", a.nbytes)
            result = client.infer("simple", inputs, outputs=[out0])
            np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), a + b)
            result.release_arena()
            with pytest.raises(port_arena.ArenaLeaseReleased):
                client.infer("simple", inputs, outputs=[out0])
            out0.release_arena_lease()
            arena.lease(a.nbytes).bind_output(out0)
            result = client.infer("simple", inputs, outputs=[out0])
            np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), a + b)
            result.release_arena()
            for inp in inputs:
                inp.set_data_from_numpy(a)  # re-staging releases the lease
            assert arena.stats()["leased_bytes"] == 0
    finally:
        arena.close(force=True)


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_digests_catch_a_scribbled_output_slab(servers, client, server):
    """``IntegrityPolicy(digests=True)``: each output slab is sealed when
    the response lands, and a byte changed in it afterwards raises a typed
    ``digest`` violation at ``as_numpy`` — the port client against either
    server, the JAX client against the JAX server."""
    port_mod, jax_mod, protocol, is_aio = CLIENTS[client]
    a, b = _pair()
    seen = {}
    for pkg, mod in (("port", port_mod), ("jax", jax_mod)):
        url = servers[(server if pkg == "port" else "jax", protocol)].url
        stats = INTEGRITY[pkg].IntegrityStats()
        policy = INTEGRITY[pkg].IntegrityPolicy(digests=True, stats=stats)
        arena = _make_arena(pkg, "device")

        async def infer_aio(inputs, outputs):
            c = mod.InferenceServerClient(url)
            try:
                c.configure_integrity(policy)
                return await c.infer("simple", inputs, outputs=outputs)
            finally:
                await c.close()

        try:
            inputs = [mod.InferInput(n, [1, 16], "INT32").set_data_from_numpy(x)
                      for n, x in (("INPUT0", a), ("INPUT1", b))]
            out0 = arena.request_output("OUTPUT0", a.nbytes)
            if is_aio:
                result = asyncio.run(infer_aio(inputs, [out0]))
            else:
                c = mod.InferenceServerClient(url)
                c.configure_integrity(policy)
                result = c.infer("simple", inputs, outputs=[out0])
                c.close()
            lease = out0._arena_lease
            sealed = lease.digest() is not None
            clean = (result.as_numpy("OUTPUT0") == a + b).all()
            lease._region._host_view()[lease.offset] ^= 0xFF
            try:
                result.as_numpy("OUTPUT0")
                caught = None
            except INTEGRITY[pkg].IntegrityError as e:
                caught = e.kind
            seen[pkg] = (sealed, bool(clean), caught,
                         stats.snapshot()["violations_by_kind"].get("digest", 0))
            result.release_arena()
            out0.release_arena_lease()
        finally:
            arena.close(force=True)
    assert seen["port"] == seen["jax"]
    assert seen["port"][:3] == (True, True, "digest")


def test_digests_off_seals_nothing(servers):
    a, b = _pair()
    arena = _make_arena("port", "device")
    try:
        with port_http.InferenceServerClient(servers[("port", "http")].url) as c:
            inputs = [port_http.InferInput(n, [1, 16], "INT32").set_data_from_numpy(x)
                      for n, x in (("INPUT0", a), ("INPUT1", b))]
            out0 = arena.request_output("OUTPUT0", a.nbytes)
            result = c.infer("simple", inputs, outputs=[out0])
            assert out0._arena_lease.digest() is None
            result.release_arena()
            out0.release_arena_lease()
    finally:
        arena.close(force=True)


# -- the cuda shm module's DLPack and inventory surface, beside the tpu module's
DLPACK_DTYPES = ["BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
                 "UINT64", "FP16", "FP32", "FP64", "BF16"]


def _consume(producer, consumer):
    """What a DLPack consumer makes of the producer: (bytes, shape) or the
    exception's type name."""
    try:
        out = consumer(producer)
    except Exception as exc:  # both packages' producers must fail alike
        return type(exc).__name__
    if isinstance(out, torch.Tensor):
        return out.view(torch.uint8).numpy().tobytes(), tuple(out.shape)
    return out.tobytes(), out.shape


@pytest.mark.parametrize("datatype", DLPACK_DTYPES)
def test_dlpack_producer_matches_tpu_module(datatype):
    """The same bytes ingested from a numpy and a torch producer, then
    exported over the host window: torch and numpy consume the port's
    producer as they consume the JAX package's, zero-copy."""
    from client_tpu.utils import tpu_shared_memory as tpushm
    from client_tpu_torch.utils._dlpack import triton_to_dlpack_dtype
    from client_tpu.utils._dlpack import triton_to_dlpack_dtype as jax_dl_dtype

    raw = np.random.default_rng(len(datatype)).integers(0, 256, 64, dtype=np.uint8)
    if datatype == "BOOL":
        raw = raw % 2
    itemsize = {"BOOL": 1, "BF16": 2}.get(datatype) or np.dtype(
        cudashm.triton_to_np_dtype(datatype)).itemsize
    shape = [2, 32 // itemsize]
    tag = f"dl{datatype.lower()}"
    regions = {"port": cudashm.create_shared_memory_region(tag, 64, device="cpu"),
               "jax": tpushm.create_shared_memory_region(tag, 64)}
    mods = {"port": cudashm, "jax": tpushm}
    try:
        seen = {}
        for pkg, mod in mods.items():
            mod.set_shared_memory_region_from_dlpack(regions[pkg], raw[:32])
            mod.set_shared_memory_region_from_dlpack(regions[pkg], torch.from_numpy(raw[32:]), 32)
            producer = mod.as_shared_memory_tensor(regions[pkg], datatype, shape)
            dl = producer.__dlpack_device__(), tuple(producer.shape), producer.triton_dtype
            seen[pkg] = (dl, _consume(producer, torch.from_dlpack),
                         _consume(mod.as_shared_memory_tensor(regions[pkg], datatype, shape),
                                  np.from_dlpack),
                         bytes(regions[pkg]._host_buf()[:64]))
        assert seen["port"] == seen["jax"]
        assert seen["port"][1][0] == raw.tobytes()
        port_dt, jax_dt = triton_to_dlpack_dtype(datatype), jax_dl_dtype(datatype)
        assert (port_dt.type_code, port_dt.bits, port_dt.lanes) == \
            (jax_dt.type_code, jax_dt.bits, jax_dt.lanes)
    finally:
        cudashm.destroy_shared_memory_region(regions["port"])
        tpushm.destroy_shared_memory_region(regions["jax"])


def test_cuda_region_dlpack_and_inventory():
    """Zero copy both ways, and the inventory row the tpu module gives for
    the same region but for its family."""
    from client_tpu.utils import tpu_shared_memory as tpushm

    region = cudashm.create_shared_memory_region("dl", 64, device="cpu")
    twin = tpushm.create_shared_memory_region("dl", 64)
    try:
        cudashm.set_shared_memory_region_from_dlpack(region, np.arange(4, dtype=np.float32))
        cudashm.set_shared_memory_region_from_dlpack(region, torch.ones(4), 16)
        producer = cudashm.as_shared_memory_tensor(region, "FP32", [8])
        assert producer.shape == (8,) and producer.triton_dtype == "FP32"
        t = torch.from_dlpack(producer)
        assert t.tolist() == [0, 1, 2, 3, 1, 1, 1, 1]
        assert np.from_dlpack(cudashm.as_shared_memory_tensor(region, "FP32", [8]))[5] == 1
        t[0] = 9  # zero-copy: the host window itself
        assert cudashm.get_contents_as_numpy(region, "FP32", [1])[0] == 9
        rows = [r for r in cudashm.region_inventory() if r["name"] == "dl"]
        assert rows == [{"family": "cuda", "name": "dl", "key": region.shm_key,
                         "byte_size": 64, "device_id": 0, "colocated": False,
                         "device_entries": 0}]
        twins = [r for r in tpushm.region_inventory() if r["name"] == "dl"]
        assert [dict(r, family="cuda", key=None) for r in twins] == [dict(rows[0], key=None)]
        assert region.host_address(8) - region.host_address() == 8 == \
            twin.host_address(8) - twin.host_address()
    finally:
        del t
        cudashm.destroy_shared_memory_region(region)
        tpushm.destroy_shared_memory_region(twin)
