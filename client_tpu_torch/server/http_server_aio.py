"""aiohttp frontend for ServerCore: the same v2 surface on an event loop.

The counterpart of ``client_tpu.server.http_server_aio``: a drop-in
alternative to the threaded frontend (``http_server.py``) for higher
request rates at many connections. One event loop accepts; model execution
runs on a worker pool whose threads make the core's device current, as the
GRPC frontend's handler threads do. Request parsing and response encoding
are the threaded frontend's, so the bytes are the same.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from aiohttp import web

from .core import InferError, ServerCore, bind_device, handler_device
from .http_server import (
    _FAMILY,
    _generate_core_request,
    _generate_event,
    _generate_once,
    _sse_event,
    encode_infer_response,
    infer_request_encoding_prefs,
    parse_infer_request,
)


def _json_response(obj: Any, status: int = 200) -> web.Response:
    return web.Response(
        body=json.dumps(obj, separators=(",", ":")).encode("utf-8"),
        status=status,
        content_type="application/json",
    )


def _error_response(e: Exception) -> web.Response:
    if isinstance(e, InferError):
        return _json_response({"error": str(e)}, e.status)
    if isinstance(e, (json.JSONDecodeError, KeyError, ValueError, TypeError)):
        # a malformed payload, as the threaded frontend answers it
        return _json_response({"error": f"failed to parse request: {e}"}, 400)
    return _json_response({"error": str(e)}, 500)


class AioHttpInferenceServer:
    """An in-process v2 HTTP server on an asyncio event loop, bound to
    localhost. ``workers``: the threads that run the models."""

    def __init__(self, core: ServerCore, port: int = 0, workers: int = 8):
        self.core = core
        self._port = port
        self._bound_port: Optional[int] = None
        self._executor = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="client_tpu_torch_aio_server",
            initializer=bind_device, initargs=(handler_device(core),),
        )
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._runner: Optional[web.AppRunner] = None

    # -- routes ------------------------------------------------------------
    def _app(self) -> web.Application:
        app = web.Application(client_max_size=2**31)
        core = self.core
        r = app.router

        async def run(fn, *args):
            return await asyncio.get_running_loop().run_in_executor(self._executor, fn, *args)

        async def live(request):
            return web.Response(status=200 if core.live else 503)

        async def ready(request):
            # drainable: drain()/close() flip core.ready
            return web.Response(status=200 if (core.live and core.ready) else 503)

        async def metrics(request):
            # not gated on core.ready: a scraper must see the drain
            return web.Response(
                body=core.metrics_registry().prometheus_text().encode(),
                content_type="text/plain", charset="utf-8")

        async def server_metadata(request):
            return _json_response(core.server_metadata())

        async def server_stats(request):
            return _json_response(core.statistics())

        async def trace_access(request):
            # traceparent-joined server spans (queue/compute ns, wall_time_s)
            return _json_response(core.access_records())

        r.add_get("/v2/health/live", live)
        r.add_get("/v2/health/ready", ready)
        r.add_get("/metrics", metrics)
        r.add_get("/v2", server_metadata)
        r.add_get("/v2/models/stats", server_stats)
        r.add_get("/v2/trace/access", trace_access)

        async def model_route(request):
            name = request.match_info["name"]
            version = request.match_info.get("version", "")
            tail = request.match_info.get("tail", "")
            try:
                if tail == "ready":
                    return web.Response(status=200 if core.model_ready(name, version) else 400)
                if tail == "config":
                    return _json_response(core.model(name, version).config())
                if tail == "stats":
                    return _json_response(core.statistics(name, version))
                if tail == "":
                    return _json_response(core.model(name, version).metadata())
                return _json_response({"error": f"unknown route {tail}"}, 404)
            except Exception as e:
                return _error_response(e)

        async def infer_route(request):
            name = request.match_info["name"]
            version = request.match_info.get("version", "")
            try:
                body = await request.read()
                header_length = request.headers.get("Inference-Header-Content-Length")
                parsed = parse_infer_request(
                    body, int(header_length) if header_length is not None else None)
                traceparent = request.headers.get("traceparent")
                if traceparent:
                    # W3C trace context: the core records a server-side span
                    # joined on this trace id (ServerCore.access_records)
                    parsed["traceparent"] = traceparent
                requested, binary_default = infer_request_encoding_prefs(parsed)
                response = await run(core.infer, name, version, parsed)
                body_out, json_size = encode_infer_response(response, requested, binary_default)
                headers = {}
                if json_size is not None:
                    headers["Inference-Header-Content-Length"] = str(json_size)
                    content_type = "application/octet-stream"
                else:
                    content_type = "application/json"
                # ORCA per-response load metrics, on the client's request
                orca = request.headers.get("endpoint-load-metrics-format")
                if orca in ("json", "text"):
                    headers["endpoint-load-metrics"] = core.orca_report(orca, name)
                return web.Response(body=body_out, headers=headers, content_type=content_type)
            except InferError as e:
                return _error_response(e)
            except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
                return _json_response({"error": f"failed to parse request: {e}"}, 400)
            except Exception as e:
                return _json_response({"error": f"internal error: {e}"}, 500)

        r.add_get("/v2/models/{name}", model_route)
        r.add_get("/v2/models/{name}/{tail:config|ready|stats}", model_route)
        r.add_get("/v2/models/{name}/versions/{version}", model_route)
        r.add_get("/v2/models/{name}/versions/{version}/{tail:config|ready|stats}",
                  model_route)
        r.add_post("/v2/models/{name}/infer", infer_route)
        r.add_post("/v2/models/{name}/versions/{version}/infer", infer_route)

        def generate_request(request, payload):
            core_req = _generate_core_request(
                core.model(request.match_info["name"], request.match_info.get("version", "")),
                payload)
            traceparent = request.headers.get("traceparent")
            if traceparent:
                # the whole generation joins the client's stream span
                core_req["traceparent"] = traceparent
            return core_req

        async def generate_route(request):
            name = request.match_info["name"]
            version = request.match_info.get("version", "")
            try:
                core_req = generate_request(request, await request.json())
                event = await run(_generate_once, core, name, version, core_req)
            except Exception as e:
                return _error_response(e)
            return _json_response(event)

        async def generate_stream_route(request):
            name = request.match_info["name"]
            version = request.match_info.get("version", "")
            loop = asyncio.get_running_loop()
            sentinel = object()
            try:
                core_req = generate_request(request, await request.json())
            except Exception as e:
                return _error_response(e)
            gen = core.infer_stream(name, version, core_req)
            fut = None

            def close_gen():
                try:
                    gen.close()
                except Exception:
                    pass

            # from here every exit (a disconnect while the first response is
            # computing, a failed prepare) runs the finally below, so the
            # model's GeneratorExit path runs now, not at GC
            try:
                fut = loop.run_in_executor(self._executor, next, gen, sentinel)
                try:
                    # shield: a disconnect must not cancel the worker
                    # mid-step (closing a running generator raises); the
                    # finally closes it after the step
                    first = await asyncio.shield(fut)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # a request-level failure is an HTTP status; failures
                    # after the first response are in-band events
                    return _error_response(e)
                resp = web.StreamResponse(
                    headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"})
                await resp.prepare(request)
                item = first
                while item is not sentinel:
                    await resp.write(_sse_event(_generate_event(item)))
                    fut = loop.run_in_executor(self._executor, next, gen, sentinel)
                    try:
                        item = await asyncio.shield(fut)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        await resp.write(_sse_event({"error": str(e)}))
                        break
                await resp.write_eof()
                return resp
            finally:
                if fut is not None and not fut.done():
                    def on_done(f):
                        if not f.cancelled():
                            f.exception()  # retrieved, so no warning
                        self._executor.submit(close_gen)
                    fut.add_done_callback(on_done)
                else:
                    self._executor.submit(close_gen)

        r.add_post("/v2/models/{name}/generate", generate_route)
        r.add_post("/v2/models/{name}/versions/{version}/generate", generate_route)
        r.add_post("/v2/models/{name}/generate_stream", generate_stream_route)
        r.add_post("/v2/models/{name}/versions/{version}/generate_stream",
                   generate_stream_route)

        async def repo_index(request):
            return _json_response(core.repository_index())

        async def repo_action(request):
            name = request.match_info["name"]
            try:
                body = await request.read()
                if request.match_info["action"] == "load":
                    payload = json.loads(body) if body else {}
                    if not isinstance(payload, dict):
                        raise InferError("load request body must be a JSON object", 400)
                    core.load_model(name, config=payload.get("parameters", {}).get("config"))
                else:
                    core.unload_model(name)
                return _json_response({})
            except Exception as e:
                return _error_response(e)

        r.add_post("/v2/repository/index", repo_index)
        r.add_post("/v2/repository/models/{name}/{action:load|unload}", repo_action)

        async def shm_route(request):
            family = _FAMILY[request.match_info["family"]]
            # the status GETs' routes carry no {action}
            action = request.match_info.get(
                "action", "status" if request.method == "GET" else "")
            region = request.match_info.get("region", "")
            try:
                if action == "status":
                    return _json_response(core.region_status(family, region))
                body = await request.read()
                payload = json.loads(body) if body else {}
                if action == "register":
                    if family == "system":
                        core.register_system_region(
                            region, payload["key"], payload.get("offset", 0),
                            payload["byte_size"])
                    else:
                        core.register_cuda_region(
                            region, payload["raw_handle"]["b64"],
                            payload.get("device_id", 0), payload["byte_size"])
                else:  # unregister
                    core.unregister_region(region or "", None if region else family)
                return _json_response({})
            except Exception as e:
                return _error_response(e)

        fam = "{family:" + "|".join(_FAMILY) + "}"
        r.add_get(f"/v2/{fam}/status", shm_route)
        r.add_get(f"/v2/{fam}/region/{{region}}/status", shm_route)
        for action in ("register", "unregister"):
            r.add_post(f"/v2/{fam}/region/{{region}}/{{action:{action}}}", shm_route)
        r.add_post(f"/v2/{fam}/{{action:unregister}}", shm_route)

        async def trace_route(request):
            if request.method == "POST":
                core.trace_settings.update(json.loads(await request.read() or b"{}"))
            return _json_response(core.trace_settings)

        async def log_route(request):
            if request.method == "POST":
                core.log_settings.update(json.loads(await request.read() or b"{}"))
            return _json_response(core.log_settings)

        for path in ("/v2/trace/setting", "/v2/models/{name}/trace/setting"):
            r.add_get(path, trace_route)
            r.add_post(path, trace_route)
        r.add_get("/v2/logging", log_route)
        r.add_post("/v2/logging", log_route)
        return app

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        return self._bound_port or self._port

    @property
    def url(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "AioHttpInferenceServer":
        def serve():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop

            async def bring_up():
                self._runner = web.AppRunner(self._app(), access_log=None)
                await self._runner.setup()
                site = web.TCPSite(self._runner, "127.0.0.1", self._port)
                await site.start()
                self._bound_port = site._server.sockets[0].getsockname()[1]
                self._started.set()

            loop.run_until_complete(bring_up())
            loop.run_forever()
            loop.run_until_complete(self._runner.cleanup())
            loop.close()

        self._thread = threading.Thread(
            target=serve, name="client_tpu_torch_aio_http_server", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("aio http server failed to start")
        return self

    def drain(self, grace_s: float = 0.0) -> None:
        """Flip ``v2/health/ready`` to 503 and wait ``grace_s`` so pool
        ready-probes route away before the listener goes; everything else
        keeps serving. ``core`` may be shared by several frontends:
        draining one drains them all."""
        self.core.ready = False
        if grace_s > 0:
            time.sleep(grace_s)

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            # serve() ends with runner.cleanup(), which waits for in-flight
            # handlers before it closes the listener
            self._thread.join(timeout=10)
            self._thread = None
        self._executor.shutdown(wait=False)

    def close(self, grace_s: float = 0.5) -> None:
        """Graceful shutdown: drain, wait ``grace_s``, finish in-flight
        handlers, then close. SIGTERM handlers call this, not ``stop``."""
        self.drain(grace_s)
        self.stop()

    def __enter__(self) -> "AioHttpInferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
