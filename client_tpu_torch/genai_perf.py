"""LLM streaming perf harness: TTFT / inter-token latency / token throughput.

The reference ecosystem measures LLM serving with genai-perf (the
perf_analyzer companion that moved out of the client repository with it):
time to first token, inter-token latency, output token throughput, request throughput,
per session-concurrency level. This is that tool for the port, built on
its own streaming GRPC and HTTP clients; a copy of ``client_tpu.genai_perf``
(the server-side decode runs the port's models, and through them the
``decode_attention`` kernel on the card).

Two serving styles, matching the two LLM fixtures:

- ``decoupled`` (default, model ``tiny_lm_generate``): one request carries
  the prompt + MAX_TOKENS and the server streams one response per
  generated token — the Triton TensorRT-LLM/vLLM backend shape. TTFT is
  send→first streamed response (prefill + first decode step + wire); each
  subsequent gap is one inter-token latency.
- ``sequence`` (model ``decoder_lm``): the client drives decoding one
  token per request over the stateful sequence API (sequence_id +
  start/end), feeding each NEXT_TOKEN back. Same metrics; the ITL now
  includes a full client round trip per token — measuring exactly what
  client-side decoding costs vs server-side generation.

Usage:
    python -m client_tpu_torch.genai_perf -u 127.0.0.1:8001 \
        --concurrency-range 1:4 --sessions 20 \
        --prompt-tokens 32 --output-tokens 32

Prints one JSON list (``-f json``) or a table; exit 1 if any level
produced zero completed sessions.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .utils import sorted_percentile as _percentile


def _summary(values: List[float]) -> Dict[str, float]:
    vs = sorted(values)
    return {
        "avg": round(sum(vs) / len(vs), 3) if vs else 0.0,
        "p50": round(_percentile(vs, 0.50), 3),
        "p90": round(_percentile(vs, 0.90), 3),
        "p99": round(_percentile(vs, 0.99), 3),
    }


class _Session:
    """Per-session measurement record (all times perf_counter seconds).

    ``tel_ttft``/``tel_itl`` (ms) are the StreamSpan-sourced twins of the
    stopwatch measurements, populated when telemetry is armed."""

    __slots__ = ("start", "first", "last", "tokens", "error",
                 "tel_ttft", "tel_itl")

    def __init__(self):
        self.start = 0.0
        self.first: Optional[float] = None
        self.last = 0.0
        self.tokens = 0
        self.error: Optional[str] = None
        self.tel_ttft: Optional[float] = None
        self.tel_itl: Optional[float] = None


class GenAiPerfRunner:
    """Drives N concurrent generation sessions and aggregates LLM metrics."""

    def __init__(self, url: str, model_name: str, mode: str,
                 prompt_tokens: int, output_tokens: int, chunk: int = 1,
                 vocab: int = 256, seed: int = 0, observe: bool = False):
        if mode not in ("decoupled", "sequence", "generate"):
            raise ValueError(f"unknown mode {mode!r}")
        if output_tokens < 1:
            raise ValueError("output_tokens must be >= 1")
        if prompt_tokens < 1:
            raise ValueError("prompt_tokens must be >= 1")
        if observe and mode == "sequence":
            # sequence mode's cleanup send can land a late response after
            # the session's mark window is read — the stopwatch stays the
            # only honest source there
            raise ValueError("--observe supports decoupled/generate modes")
        self.url = url
        self.model_name = model_name
        self.mode = mode
        self.prompt_tokens = prompt_tokens
        self.output_tokens = output_tokens
        self.chunk = chunk
        self.vocab = vocab
        self.seed = seed
        self.telemetry = None
        if observe:
            from .observe import Telemetry

            # sample=off: per-session readings come straight from the
            # client's StreamSpan handle; the ring is not needed and a
            # long sweep must not grow it
            self.telemetry = Telemetry(sample="off")

    # -- one session ---------------------------------------------------------
    def _prompt(self, rng: np.random.Generator) -> np.ndarray:
        return rng.integers(
            0, self.vocab, size=(1, self.prompt_tokens), dtype=np.int32)

    def _run_decoupled_session(self, client, InferInput, sess: _Session,
                               responses: "queue.Queue",
                               rng: np.random.Generator) -> None:
        """One request → stream of per-token responses until the final
        marker (triton_enable_empty_final_response semantics)."""
        tokens_in = InferInput("TOKENS", [1, self.prompt_tokens], "INT32")
        tokens_in.set_data_from_numpy(self._prompt(rng))
        max_in = InferInput("MAX_TOKENS", [1], "INT32")
        max_in.set_data_from_numpy(
            np.array([self.output_tokens], dtype=np.int32))
        params = {"chunk": self.chunk} if self.chunk != 1 else None

        # telemetry window: the stream's span marks every response; this
        # session's marks are the ones appended after n0 (sessions run
        # sequentially per worker stream)
        span = client.stream_span() if self.telemetry is not None else None
        n0 = span.chunk_count if span is not None else 0
        sess.start = time.perf_counter()
        start_ns = time.perf_counter_ns()
        client.async_stream_infer(
            self.model_name, [tokens_in, max_in],
            enable_empty_final_response=True,
            parameters=params,
        )
        while True:
            result, error = responses.get(timeout=120.0)
            now = time.perf_counter()
            if error is not None:
                sess.error = str(error) or "stream error"
                return
            if result.is_final_response() and result.is_null_response():
                sess.last = sess.last or now
                break
            if sess.first is None:
                sess.first = now
            sess.last = now
            sess.tokens += 1
        if span is not None and sess.tokens:
            # marks include the empty final-response frame: the session's
            # token marks are the first `tokens` entries of its window
            marks = span.marks_ns()[n0:][:sess.tokens]
            if marks:
                sess.tel_ttft = (marks[0] - start_ns) / 1e6
            if len(marks) > 1:
                sess.tel_itl = (marks[-1] - marks[0]) / 1e6 / (len(marks) - 1)

    def _run_generate_session(self, client, sess: _Session,
                              rng: np.random.Generator) -> None:
        """One generate-extension SSE stream over HTTP — the transport the
        reference genai-perf drives against tritonserver's
        extension_generate endpoints. Same metrics as decoupled mode; the
        per-token gap now includes SSE framing + chunked HTTP delivery.

        Fully-consumed streams release their connection back to the pool
        (generate_stream's exhausted path), so per-session TTFT measures
        the protocol, not a fresh TCP handshake — keeping the committed
        decoupled-vs-generate comparison fair against the long-lived GRPC
        stream modes (only abandoned/error sessions pay a reconnect)."""
        inputs: Dict[str, Any] = {
            "TOKENS": self._prompt(rng).tolist(),
            "MAX_TOKENS": self.output_tokens,
        }
        params = {"chunk": self.chunk} if self.chunk != 1 else None
        sess.start = time.perf_counter()
        for _event in client.generate_stream(
            self.model_name, inputs, parameters=params
        ):
            now = time.perf_counter()
            if sess.first is None:
                sess.first = now
            sess.last = now
            sess.tokens += 1
        if self.telemetry is not None:
            # single source of truth: the session IS one StreamSpan —
            # TTFT/ITL come from its marks, not this loop's stopwatch
            span = client.last_stream_span()
            if span is not None:
                ttfts = span.ttft_ms_per_attempt()
                if ttfts:
                    sess.tel_ttft = ttfts[0]
                itls = span.itl_values_ms()
                if itls:
                    sess.tel_itl = sum(itls) / len(itls)

    def _run_sequence_session(self, client, InferInput, sess: _Session,
                              responses: "queue.Queue", sequence_id: int,
                              rng: np.random.Generator) -> None:
        """Client-driven decode loop over the stateful sequence API.

        Always closes the sequence: the server keeps per-sequence KV caches
        until a sequence_end arrives (decoder.py state map), so an aborted
        session must still send end=True or every error leaks a cache."""
        ended = False

        def send(tokens: np.ndarray, start: bool, end: bool):
            nonlocal ended
            inp = InferInput("TOKENS", list(tokens.shape), "INT32")
            inp.set_data_from_numpy(tokens)
            client.async_stream_infer(
                self.model_name, [inp], sequence_id=sequence_id,
                sequence_start=start, sequence_end=end)
            ended = ended or end

        def recv() -> Optional[int]:
            result, error = responses.get(timeout=120.0)
            if error is not None:
                sess.error = str(error) or "stream error"
                return None
            return int(result.as_numpy("NEXT_TOKEN").reshape(-1)[0])

        try:
            sess.start = time.perf_counter()
            send(self._prompt(rng), start=True, end=self.output_tokens == 1)
            nxt = recv()
            if nxt is None:
                return
            now = time.perf_counter()
            sess.first = sess.last = now
            sess.tokens = 1
            while sess.tokens < self.output_tokens:
                last = sess.tokens + 1 >= self.output_tokens
                send(np.array([[nxt]], dtype=np.int32), start=False, end=last)
                nxt = recv()
                if nxt is None:
                    return
                sess.last = time.perf_counter()
                sess.tokens += 1
        finally:
            if not ended:
                # best-effort server-side state cleanup; whatever response
                # or error this produces lands in a queue the worker
                # discards (error paths rebuild the stream + queue)
                try:
                    send(np.array([[0]], dtype=np.int32), start=False, end=True)
                except Exception:
                    pass

    # -- one concurrency level ----------------------------------------------
    def run(self, concurrency: int, sessions: int) -> Dict[str, Any]:
        from .grpc import InferenceServerClient, InferInput

        done: List[_Session] = []
        done_lock = threading.Lock()
        counter = {"n": 0}
        seq_counter = {"n": int(time.time()) % 100000 * 1000}
        barrier = threading.Barrier(concurrency + 1)

        def worker(worker_id: int):
            # numpy Generators are not thread-safe: one independent
            # stream per worker (seeded deterministically per id)
            rng = np.random.default_rng((self.seed, worker_id))
            # the callback reads the queue through this holder so a stream
            # rebuild can swap in a fresh queue atomically
            holder = {"q": queue.Queue()}
            client = None
            setup_error: Optional[str] = None
            try:
                if self.mode == "generate":
                    from .http import InferenceServerClient as HttpClient

                    client = HttpClient(self.url)
                    if self.telemetry is not None:
                        client.configure_telemetry(self.telemetry)
                else:
                    client = InferenceServerClient(self.url)
                    if self.telemetry is not None:
                        # before start_stream: the stream span must exist
                        # from the first session's first response
                        client.configure_telemetry(self.telemetry)
                    client.start_stream(
                        lambda result, error: holder["q"].put((result, error)))
            except Exception as e:
                # keep the thread alive through barrier.wait() — dying here
                # would strand run() on the barrier forever
                setup_error = f"worker setup failed: {e}"
            try:
                barrier.wait()
                while True:
                    with done_lock:
                        if counter["n"] >= sessions:
                            return
                        counter["n"] += 1
                        seq_counter["n"] += 1
                        seq_id = seq_counter["n"]
                    sess = _Session()
                    if setup_error is not None:
                        sess.error = setup_error
                    else:
                        try:
                            if self.mode == "decoupled":
                                self._run_decoupled_session(
                                    client, InferInput, sess, holder["q"],
                                    rng)
                            elif self.mode == "generate":
                                self._run_generate_session(client, sess, rng)
                            else:
                                self._run_sequence_session(
                                    client, InferInput, sess, holder["q"],
                                    seq_id, rng)
                        except Exception as e:  # survive one bad session
                            sess.error = str(e) or type(e).__name__
                        if sess.error is not None and self.mode != "generate":
                            # the broken session's late responses may still
                            # be in flight: cancel the stream, then swap in
                            # a fresh queue so the next session can't
                            # consume another session's tokens
                            try:
                                client.stop_stream(cancel_requests=True)
                            except Exception:
                                pass
                            holder["q"] = queue.Queue()
                            try:
                                client.start_stream(
                                    lambda result, error:
                                    holder["q"].put((result, error)))
                            except Exception as e:
                                setup_error = f"stream restart failed: {e}"
                    with done_lock:
                        done.append(sess)
            finally:
                if client is not None:
                    try:
                        if self.mode != "generate":
                            client.stop_stream()
                        client.close()
                    except Exception:
                        pass

        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(concurrency)
        ]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0

        ok = [s for s in done if s.error is None and s.first is not None]
        errors = [s for s in done if s.error is not None]
        # error-free sessions that streamed zero tokens: neither completed
        # nor errored — dropping them from both buckets silently
        # undercounted (they break the tokens-received contract, so they
        # count toward the nonzero exit the same way errors do)
        incomplete = [s for s in done
                      if s.error is None and s.first is None]
        ttft_ms = [(s.first - s.start) * 1e3 for s in ok]
        e2e_ms = [(s.last - s.start) * 1e3 for s in ok]
        itl_ms: List[float] = []
        for s in ok:
            if s.tokens > 1:
                itl_ms.append((s.last - s.first) * 1e3 / (s.tokens - 1))
        total_tokens = sum(s.tokens for s in ok)
        result = {
            "mode": self.mode,
            "model": self.model_name,
            "concurrency": concurrency,
            "sessions": len(ok),
            "errors": len(errors),
            "incomplete": len(incomplete),
            "error_sample": errors[0].error if errors else None,
            "prompt_tokens": self.prompt_tokens,
            "output_tokens": self.output_tokens,
            "chunk": self.chunk,
            "wall_s": round(wall, 3),
            "ttft_ms": _summary(ttft_ms),
            "inter_token_ms": _summary(itl_ms),
            "e2e_ms": _summary(e2e_ms),
            "output_tokens_per_sec": round(total_tokens / wall, 1) if wall else 0.0,
            "requests_per_sec": round(len(ok) / wall, 2) if wall else 0.0,
        }
        if self.telemetry is not None:
            self._telemetry_result(result, ok, ttft_ms, itl_ms)
        return result

    # the stopwatch re-measures what the StreamSpan already recorded: its
    # only job with telemetry armed is to BOUND the span's numbers. Agree-
    # ment within the floor validates both; divergence beyond it flags a
    # broken clock path, not noise.
    TELEMETRY_NOISE_FLOOR_MS = 2.0
    TELEMETRY_NOISE_FLOOR_FRAC = 0.10

    def _telemetry_result(self, result: Dict[str, Any], ok: List[_Session],
                          sw_ttft: List[float], sw_itl: List[float]) -> None:
        """Emit the StreamSpan-sourced TTFT/ITL as the headline numbers
        (single source of truth), keep the stopwatch twins for the A/B,
        and flag divergence beyond the noise floor."""
        tel_ttft = [s.tel_ttft for s in ok if s.tel_ttft is not None]
        tel_itl = [s.tel_itl for s in ok if s.tel_itl is not None]
        if not tel_ttft:
            result["telemetry_source"] = None
            return
        result["telemetry_source"] = "stream_span"
        result["ttft_ms_stopwatch"] = result["ttft_ms"]
        result["inter_token_ms_stopwatch"] = result["inter_token_ms"]
        result["ttft_ms"] = _summary(tel_ttft)
        result["inter_token_ms"] = _summary(tel_itl)
        divergence = {}
        warned = False
        for key, sw in (("ttft_p50_ms", result["ttft_ms_stopwatch"]),
                        ("itl_p50_ms", result["inter_token_ms_stopwatch"])):
            tel_summary = (result["ttft_ms"] if key.startswith("ttft")
                           else result["inter_token_ms"])
            delta = round(tel_summary["p50"] - sw["p50"], 3)
            divergence[key] = delta
            floor = max(self.TELEMETRY_NOISE_FLOOR_MS,
                        self.TELEMETRY_NOISE_FLOOR_FRAC * abs(sw["p50"]))
            if abs(delta) > floor:
                warned = True
        result["telemetry_divergence_ms"] = divergence
        result["telemetry_warning"] = warned


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="client_tpu_torch.genai_perf",
        description="LLM streaming perf: TTFT / inter-token latency / token throughput",
    )
    parser.add_argument("-u", "--url", default="127.0.0.1:8001",
                        help="GRPC endpoint (decoupled/sequence) or HTTP "
                             "endpoint (generate mode)")
    parser.add_argument("-m", "--model-name", default=None,
                        help="default: tiny_lm_generate (decoupled/generate)"
                             " / decoder_lm (sequence)")
    parser.add_argument("--mode", choices=("decoupled", "sequence", "generate"),
                        default="decoupled",
                        help="decoupled: GRPC bi-di stream; generate: the "
                             "HTTP generate-extension SSE endpoint (what "
                             "the reference genai-perf drives); sequence: "
                             "client-driven stateful decode")
    parser.add_argument("--concurrency-range", default="1",
                        help="start[:end[:step]] concurrent sessions")
    parser.add_argument("--sessions", type=int, default=20,
                        help="measured sessions per concurrency level")
    parser.add_argument("--prompt-tokens", type=int, default=32)
    parser.add_argument("--output-tokens", type=int, default=32)
    parser.add_argument("--chunk", type=int, default=1,
                        help="tokens per device dispatch (decoupled mode)")
    parser.add_argument("--warmup-sessions", type=int, default=2)
    parser.add_argument(
        "--observe", action="store_true",
        help="arm client telemetry and source TTFT/ITL from the "
             "StreamSpan instead of this tool's stopwatch (both are "
             "emitted; divergence beyond the noise floor is flagged). "
             "decoupled/generate modes only")
    parser.add_argument("-f", "--format", choices=("table", "json"),
                        default="table")
    args = parser.parse_args(argv)

    model = args.model_name or (
        "decoder_lm" if args.mode == "sequence" else "tiny_lm_generate")
    parts = [int(x) for x in args.concurrency_range.split(":")]
    start = parts[0]
    end = parts[1] if len(parts) > 1 else start
    step = parts[2] if len(parts) > 2 else 1

    runner = GenAiPerfRunner(
        args.url, model, args.mode, args.prompt_tokens, args.output_tokens,
        chunk=args.chunk, observe=args.observe)
    if args.warmup_sessions:
        runner.run(1, args.warmup_sessions)

    results = []
    for concurrency in range(start, end + 1, step):
        results.append(runner.run(concurrency, args.sessions))

    for r in results:
        if r.get("telemetry_warning"):
            print(
                f"WARNING: concurrency {r['concurrency']}: StreamSpan vs "
                f"stopwatch divergence beyond the noise floor: "
                f"{r['telemetry_divergence_ms']}", file=sys.stderr)

    if args.format == "json":
        print(json.dumps(results))
    else:
        print(f"model={model} mode={args.mode} prompt={args.prompt_tokens} "
              f"max_tokens={args.output_tokens} chunk={args.chunk}")
        print(f"{'conc':>5} {'sess':>5} {'ttft p50':>9} {'ttft p99':>9} "
              f"{'itl p50':>8} {'itl p99':>8} {'tok/s':>8} {'req/s':>7} {'err':>4}")
        for r in results:
            print(f"{r['concurrency']:>5} {r['sessions']:>5} "
                  f"{r['ttft_ms']['p50']:>9} {r['ttft_ms']['p99']:>9} "
                  f"{r['inter_token_ms']['p50']:>8} {r['inter_token_ms']['p99']:>8} "
                  f"{r['output_tokens_per_sec']:>8} {r['requests_per_sec']:>7} "
                  f"{r['errors']:>4}")
    return 1 if any(not r["sessions"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
