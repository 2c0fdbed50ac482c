#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``client_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: the ``nvidia-smi`` name and power-limit line;
2. build: every kernel under ``client_tpu_torch/csrc`` (decode_attention,
   flash_attention, normalize_image, quantize_int8, softmax) built from
   source with nvcc into ``build/torch_kernels/``, one compiler per source,
   with ptxas's lines (registers, static shared memory and spills) for each
   entry function, and the flash kernels' dynamic shared memory;
3. kernels: each kernel wrapper against its plain PyTorch version on the
   card, with the kernel, the plain version and one PyTorch library call
   (where one computes the same function) timed by CUDA events beside the
   least time the card could take:
   - decode_attention at the reference test shapes, the decoder's shape,
     the batched decode step's (8, 4, 128, 32) at mixed positions (0, 127
     and an idle slot among them) and large cache shapes; split-K cases (positions on a split boundary, a
     position inside the first of many splits so the rest are empty, a
     cache length that splits unevenly) and a short cache in fp32 and bf16
     at D = 32, 64 and 128; the device time (profiler) of the large shapes beside the
     per-call time;
   - flash_attention in fp32 at the JAX tests' shapes, block pairs and
     causal settings (the result must not depend on the blocks), in bf16 at
     the JAX chip benchmark's (4, 2048, 8, 128), and at the served
     long_context_encoder shape (1, S, 4, 16) for S = 100, 4096, 8192, and
     at ragged lengths S = 1, 63, 65, 130 for every D, both dtypes and both
     causal settings (the bf16 tensor-core kernel and the fp32 kernels);
     in bf16 also against the tiled plain version (p rounded before PV), at
     one bf16 ulp;
   - quantize_int8 element-exact (exact half-steps, values past the clip;
     fp32, bf16 and fp16 in) at (1, 8192), a ragged length, 64 MiB and an
     unaligned view; dequantize_int8 element-exact to fp32, bf16 and fp16
     over every int8 value, at (1, 8192), a ragged length, one below and
     one above a whole word and a whole grid step, 64 MiB, and with the
     input off 16-byte alignment; ``torch.quantize_per_tensor`` timed as quantize's library
     call, with the count of its int8 values that differ from the kernel's;
   - normalize_image element-exact (fp32, uint8, bf16, fp16 and int32 in;
     fp32, bf16 and fp16 out; INCEPTION and NONE) at (224, 224, 3), (7, 13,
     3), 64 MiB of fp32 and an unaligned view, int32 past 2**24, and every
     path one below and one above a whole vector and a whole grid step;
     softmax_probabilities within rtol 1e-5 at the served (1, 1000) and at
     (8, 1000), (3, 50) x 30, (1000,), bf16, a long row and (16384, 1000),
     then at widths from 1 to 8200 columns at 1, 8 and 16384 rows in fp32,
     bf16 and fp16 (every variant, warps and vectors count of
     ``softmax_plan`` must occur), an unaligned row and rows of -inf, NaN
     and +inf;
   - classification ties on the card: ``ops.topk_classification`` and the
     server's classification extension on tied rows (int32, float, all
     equal, bf16-rounded logits) and on rows without ties give the CPU's
     order, lowest index first (how ``torch.topk`` orders the same ties on
     the card is recorded); then ``ops.topk_classification`` (a stable
     sort) and ``torch.topk``, each alone and with its copies to the host,
     timed at (1, 1000), (64, 1000) and (16384, 1000): wall per call in
     interleaved rounds, and on the device (profiler);
   - no fallback: a CUDA tensor of a dtype or head dim a kernel has no code
     for raises and launches nothing; decode and flash views off 16-byte
     alignment run on aligned copies and agree with the plain versions;
   - the small kernels (normalize, softmax, quantize, dequantize, and
     dequantize to bf16 at 64 MiB) and their library calls each timed per
     call, on the device (profiler) and, at the served shapes, on the host
     per call (enqueue, no sync), beside the card's write ceiling (``fill_``
     of 64 MiB); the host time of one
     normalize_image call split into its pieces, before and after the
     wrappers shared one launch path;
4. server: the port's HTTP server with its model zoo and
   ``long_context_encoder`` on the GPU, driven by the port's client, each
   path with every launch count set to 0 just before it and read just
   after:
   - ``simple`` over the wire; ``identity_fp32`` at 4 MiB and 64 MiB over
     the wire, system shared memory and colocated cuda shared memory;
     ``decoder_lm`` over the sequence API and ``tiny_lm_generate`` over
     ``generate_stream``, checked against a CPU run of the port with the
     same weights (decode_attention launches = tokens x layers);
   - ``decoder_lm_batched`` over HTTP to 8 concurrent sequences (prompts
     of 1-8 tokens, then 8 greedy continuations; the first window holds
     all 8 starts), each sequence's tokens equal to ``decoder_lm``'s on the
     card and to a CPU run's, logits within 5e-2, a round of width >= 4,
     decode_attention launches = rounds x layers; in process, a sequence
     at pos == MAX_LEN riding along untouched while another decodes;
     ``decoder_lm_prefill`` rows bit-equal to ``decoder_lm``; the disagg
     pair's KV handed over on the device through a colocated cuda shm
     region into ``ServerCore.infer_stream``, the stream equal to
     ``tiny_lm_generate``'s; batched rounds timed in process at 1, 2, 4
     and 8 active sequences, with the device time and idle share of a
     round at 8;
   - ``long_context_encoder`` (flash, dim 64, heads 4) at S = 100, 4096 and
     8192 over the wire and colocated cuda shared memory, checked against a
     CPU run of the port with the same weights (flash_attention launches =
     requests), with its request p50 by data plane;
   - the int8 wire path of ``examples/quantized_wire_client.py``: quantize
     on the card, INT8 through ``identity_int8``, dequantize, error within
     half a step (one quantize and one dequantize launch per round trip);
   - the vision path, ``build_image_ensemble`` at width 96 / 1000 classes
     (weights from seed 0) in a server of its own: the image_client flow
     (normalize on the card, ``densenet_onnx`` over the wire and colocated
     cuda shm, softmax of the logits in the output region) and the
     ensemble_image flow (raw UINT8 over the wire), each checked against a
     CPU run of the port with the same weights (top-1 equal, logits within
     5e-2; normalize launches = requests, softmax launches = calls), with
     the p50 of each plane and an in-process profile of densenet_onnx.

5. GRPC: the port's GRPC server over ``ServerCore(default_model_zoo("cuda"))``
   plus the vision models, driven by the port's GRPC clients, each path with
   every launch count set to 0 just before it and read just after:
   - ``simple``, then health, metadata, config, the repository index,
     unload and load, and statistics (success count = requests sent);
   - ``identity_fp32`` at 4 MiB and 64 MiB over the GRPC wire, system shm
     and colocated cuda shm (host windows all-zero), p50 beside HTTP's;
   - ``decoder_lm`` over one bidi stream, the tokens equal to the HTTP
     phase's and the CPU run's (decode_attention launches = tokens x
     layers);
   - ``decoder_lm_batched`` over 8 concurrent streams (the first window
     holding all 8 starts), each sequence's tokens equal to ``decoder_lm``'s
     on the card, a round of width >= 4 (launches = rounds x layers);
   - the image_client flow with input and logits in colocated cuda shm
     (normalize and softmax on the card; top-1 equal to the CPU run;
     normalize launches = requests, softmax launches = calls);
   - ``grpc.aio`` and ``http.aio`` (an HTTP frontend on the same core) each
     sending ``simple`` and ``identity_fp32`` (cuda shm) requests through
     ``asyncio.gather``, their outputs equal.

6. resilience and observability: the port's HTTP and GRPC servers over the
   default zoo plus the vision models, the port's ``testing.ChaosProxy`` in
   front of each, every client with contract validation on
   (``integrity``), a process-wide data-plane recorder; each path with every
   launch count set to 0 just before it and read just after, decode_attention
   launches held to what the server ran (its execution count and each
   request's tokens, times the layers):
   - the image_client flow (normalize and softmax on the card, the image over
     the wire) under ``flap`` and ``reset@N`` with a seeded ``RetryPolicy``:
     zero errors, top-1 equal to the CPU run;
   - a ``decoder_lm`` sequence under ``reset@N``: the faulted request makes
     one attempt and raises (never re-sent), the tokens before it equal the
     CPU run's;
   - ``decoder_lm`` over a GRPC bidi stream with ``auto_reconnect=True``
     under a reset: one ``StreamReconnected`` naming the in-flight sequence
     request as abandoned, the sequence re-driven to the CPU run's tokens, a
     ``StreamChecker`` on each wire stream's response ids;
   - a ``CircuitBreaker`` under ``blackhole``: it opens, fast-fails without
     a connection and is half-open probed once; the ``FlightRecorder``
     retains each failure the caller saw;
   - ``Telemetry`` at ratio 1.0 on identity_fp32 at 4 MiB (wire and
     colocated cuda shm), decoder_lm per token and the image_client flow
     (cuda shm): client phase p50s beside the server's queue and compute
     time, joined by trace id, and one request's ``compute_ns`` beside its
     device time from the profiler;
   - the hooks' host cost: identity_fp32 over cuda shm and decoder_lm per
     token with no hooks and with telemetry, resilience and integrity, in
     interleaved rounds;
   - ``/metrics`` counts equal to the statistics, the cuda data-plane
     counters equal to the creates, registers, destroys and requests made,
     zero integrity violations.

7. the measurement harness: the port's ``perf``, ``genai_perf`` and
   ``trace`` against its HTTP and GRPC servers over the default zoo, the
   image ensemble and ``long_context_encoder`` (``serve_harness``), each
   path with every launch count set to 0 just before it and read just
   after:
   - ``PerfRunner`` closed loops at concurrency 1, 2 and 4: identity_fp32
     at 4 MiB over shm none, system and cuda (and cuda over GRPC),
     ensemble_image at (224, 224, 3) and long_context_encoder at S = 8192
     over cuda shm (normalize_image launches = the ensemble's executions,
     flash_attention = the encoder's);
   - one poisson open loop on identity_fp32 over cuda shm at half the
     closed loop's rate at concurrency 1;
   - the replay of a seeded mixed trace (unary, sequence and streamed
     generations) over HTTP (decode_attention launches = the layers times
     the streams' prompt and generated tokens but the last);
   - ``GenAiPerfRunner``: decoupled ``tiny_lm_generate`` over GRPC,
     ``decoder_lm_batched`` sequences at 1 and 8 concurrent sessions
     (launches = rounds x layers) and the HTTP generate extension, the
     tokens received = sessions x output tokens;
   every row with 0 errors and the server's success count equal to the
   requests sent, the cuda arenas' regions equal to what their size
   classes need (not the requests), none resident after the arenas close.

It then prints one ``{"kernels": [...]}`` line and, last, one line
``{"ok": true, "device": {...}}``. Details go to ``build/chip_smoke.json``.
Without a CUDA device it fails. The build fails if ptxas reports a spill in
the softmax, normalize or int8 kernels.

``python3 chip_smoke.py --kernel-times`` builds the kernels and times the
small kernels and the wrappers' host cost alone (the same rows as phase
3), ending with one ``{"kernel_times": ...}`` line. It calls only the
port's public wrappers, so a copy of this file placed in an earlier tree of
the port times that tree, for a comparison inside one run.
"""

from __future__ import annotations

import asyncio
import collections
import ctypes
import json
import os
import queue
import random
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from contextlib import nullcontext

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import client_tpu_torch.grpc as grpcclient  # noqa: E402
import client_tpu_torch.grpc.aio as grpc_aio  # noqa: E402
import client_tpu_torch.http as httpclient  # noqa: E402
import client_tpu_torch.http.aio as http_aio  # noqa: E402
import client_tpu_torch.ops.quantize as qz  # noqa: E402
from client_tpu_torch import ops  # noqa: E402
from client_tpu_torch.models import DenseNetModel, ImagePreprocessModel  # noqa: E402
from client_tpu_torch.models import LongContextEncoderModel, default_model_zoo  # noqa: E402
from client_tpu_torch.models import build_image_ensemble  # noqa: E402
from client_tpu_torch.models.vision import flops_per_image  # noqa: E402
from client_tpu_torch.ops import normalize as nz  # noqa: E402
from client_tpu_torch.ops import softmax as sm  # noqa: E402
from client_tpu_torch.models.long_context import WEIGHTS, load_jax_params  # noqa: E402
from client_tpu_torch.models.decoder import TinyDecoderModel  # noqa: E402
from client_tpu_torch.models.decoder_batched import _SeqRequest  # noqa: E402
from client_tpu_torch.models.generate import TinyGenerateModel  # noqa: E402
from client_tpu_torch.ops import _kernels  # noqa: E402
from client_tpu_torch.ops import decode_attention as da  # noqa: E402
# the module's names (ops.flash_attention itself is the function)
from client_tpu_torch.ops.flash_attention import LAUNCHES as FLASH_LAUNCHES  # noqa: E402
from client_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_reference,
    flash_attention_tiled_reference,
)
from client_tpu_torch import trace as trace_mod  # noqa: E402
from client_tpu_torch.flight import FlightRecorder  # noqa: E402
from client_tpu_torch.genai_perf import GenAiPerfRunner  # noqa: E402
from client_tpu_torch.integrity import IntegrityPolicy, IntegrityStats, StreamChecker  # noqa: E402
from client_tpu_torch.perf import PerfRunner  # noqa: E402
from client_tpu_torch.observe import (  # noqa: E402
    Telemetry,
    dataplane,
    enable_dataplane,
    install_dataplane,
)
from client_tpu_torch.resilience import (  # noqa: E402
    CircuitBreaker,
    CircuitOpenError,
    ResiliencePolicy,
    RetryPolicy,
    StreamReconnected,
    classify_fault,
)
from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer, ServerCore  # noqa: E402
from client_tpu_torch.testing import ChaosProxy, Fault  # noqa: E402
from client_tpu_torch.utils import InferenceServerException  # noqa: E402
from client_tpu_torch.utils import cuda_shared_memory as cudashm  # noqa: E402
from client_tpu_torch.utils import numpy_to_tensor  # noqa: E402
from client_tpu_torch.utils import shared_memory as shm  # noqa: E402

# H100 SXM (NVIDIA data sheet): HBM bandwidth and dense peaks, per dtype
# (float32 outside the tensor cores: the port's fp32 kernels use no TF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the small kernels' float types (fp16 too)
FLOATS = {**DTYPES, "float16": torch.float16}
# kernel against its plain version, per kernel and dtype:
# - decode_attention: max |out - ref| < tol (tests/test_decode_attention.py);
# - flash_attention: |out - ref| <= tol + tol * |ref| elementwise, the JAX
#   tests' atol = rtol (tests/test_utils.py: 2e-5 in fp32); in bf16 2e-2, as
#   the kernel rounds p to bf16 before PV and the output to bf16, where the
#   plain version keeps fp32;
# - quantize_int8 / dequantize_int8: element exact;
# - normalize_image: element exact (both round f32(x)*scale+shift once);
# - softmax_probabilities: rtol 1e-5, atol 1e-30 (tests/test_utils.py's
#   bound against JAX; exp and the sums differ in the last bits).
TOLERANCE = {
    "decode_attention": {"float32": 1e-5, "bfloat16": 2e-2},
    "flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
    "quantize_int8": 0.0,
    "dequantize_int8": 0.0,
    "normalize_image": 0.0,
    "softmax_probabilities": {"rtol": 1e-5, "atol": 1e-30},
}
# flash_attention in bf16 against its tiled plain version (the same 64-key
# tiles, p rounded to bf16 before PV), elementwise |out - ref| <= atol +
# rtol * |ref|: rtol one bf16 ulp (2^-7, as the CPU tests hold the tiled
# version against the Pallas kernel), atol 2^-9, the largest difference
# seen on the card over every bf16 case (PERF.md): the two differ only in
# fp32 rounding, which flips a few p or outputs by one bf16 ulp
TILED_TOLERANCE = {"atol": 2.0 ** -9, "rtol": 2.0 ** -7}
# the kernels redesigned since their port, and how (their earlier times
# are in PERF.md)
REDESIGNED = {"decode_attention": "split-K over the cache",
              "flash_attention": "bf16 on the tensor cores",
              "normalize_image": "a lane per 16-byte output word",
              "softmax_probabilities": "rows held in registers",
              "dequantize_int8": "a lane per 16-byte output word (normalize's word loop)"}
# launch counters of the kernel wrappers, by kernel name
COUNTERS = {
    "decode_attention": da.LAUNCHES,
    "flash_attention": FLASH_LAUNCHES,
    "quantize_int8": qz.QUANTIZE_LAUNCHES,
    "dequantize_int8": qz.DEQUANTIZE_LAUNCHES,
    "normalize_image": nz.LAUNCHES,
    "softmax_probabilities": sm.LAUNCHES,
}

MIB = 1 << 20


def reset_counts() -> None:
    for counter in COUNTERS.values():
        counter.reset()


def read_counts():
    return {name: counter.count for name, counter in COUNTERS.items()}


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def demangle(names):
    """Readable names of mangled entry functions, by the CUDA toolkit's
    ``cu++filt -p``; the mangled names where it is missing."""
    tool = os.path.join(os.path.dirname(_kernels.nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return list(names)
    out = subprocess.run([tool, "-p", *names], capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_lines(name: str, log: str):
    """ptxas's registers / static shared memory line and its stack and
    spill line, per entry function of one source."""
    lines, entry = [], "?"
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            entry = found.group(1)
        elif "registers" in line or "spill" in line:
            lines.append((entry, line.strip()))
    entries = sorted({entry for entry, _ in lines})
    readable = dict(zip(entries, demangle(entries)))
    return [f"{name}: {readable[entry]}: {text}" for entry, text in lines]


def build_kernels():
    t0 = time.perf_counter()
    logs = _kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [line for name, text in logs.items() for line in ptxas_lines(name, text)]
    spills = [line for line in ptxas
              if line.startswith(("softmax:", "normalize_image:", "quantize_int8:"))
              and re.search(r"[1-9]\d* bytes spill", line)]
    if spills:
        raise AssertionError(f"ptxas spills in the softmax, normalize or int8 kernels: {spills}")
    return seconds, ptxas


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 10000, batch: int = 100) -> float:
    """Median host time in microseconds to enqueue one call of ``fn`` (no
    synchronisation inside the timed call), over ``calls`` calls made in
    batches of ``batch``; the device is drained between batches, untimed,
    so the launch queue never fills."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls // batch):
        for _ in range(batch):
            t0 = time.perf_counter_ns()
            fn()
            times.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def sms() -> int:
    """The card's SM count (what the decode wrapper plans its splits for)."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def attention_inputs(batch, heads, max_len, dim, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((batch, heads, dim), generator=gen, device="cuda").to(dtype)
    k = torch.randn((batch, heads, max_len, dim), generator=gen, device="cuda").to(dtype)
    v = torch.randn((batch, heads, max_len, dim), generator=gen, device="cuda").to(dtype)
    return q, k, v


def attention_bound_ms(batch, heads, max_len, dim, positions, itemsize, dtype_name) -> float:
    """Least time: every live cache row, q and pos read once, the output
    written once, over the HBM rate — or the flops over the peak, if larger."""
    live = sum(min(p, max_len - 1) + 1 for p in positions) * heads
    nbytes = (2 * live * dim + 2 * batch * heads * dim) * itemsize + 4 * batch
    flops = 4 * live * dim
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]) * 1e3


def check_decode_attention():
    """Every case: the kernel against the plain version on the same inputs."""
    dtypes = DTYPES
    tol = TOLERANCE["decode_attention"]
    cases = []
    for (b, h, m, d) in ((1, 4, 128, 32), (3, 2, 200, 64), (2, 8, 384, 128)):
        for p in (0, m - 1):
            for name in dtypes:
                cases.append(("reference", (b, h, m, d), [p] * b, name))
    # the reference test's own mixed positions within a batch
    for shape, positions in (((1, 4, 128, 32), [5]), ((3, 2, 200, 64), [0, 99, 199]),
                             ((2, 8, 384, 128), [100, 383])):
        for name in dtypes:
            cases.append(("reference", shape, positions, name))
    # the decoder's own shape at a mid-run position, and the batched step's
    # (B = slots) at mixed positions in both dtypes
    cases.append(("decoder", (1, 4, 128, 32), [11], "bfloat16"))
    for name in dtypes:
        cases.append(("batched", BATCHED_SHAPE, BATCHED_POS, name))
    # one split over a cache so short that the kernel unrolls less: at M = 24
    # a lane group loads 1, 2 or 4 slots at a time, by D and dtype
    for d in (32, 64, 128):
        for name in dtypes:
            cases.append(("short_cache", (2, 2, 24, d), [23, 5], name))
    # split-K: 4099 slots (prime: every split boundary is ragged) with the
    # two sequences' last slots on either side of the first boundary, or one
    # at the end and one mid-way; 65536 slots in as many splits as the plan
    # allows with pos inside the first, so every other partial is empty
    for d in (32, 64, 128):
        for name in dtypes:
            first = da.split_bounds(4099, da.split_plan(2, 2, 4099, sms()))[1][0]
            cases.append(("split_boundary", (2, 2, 4099, d), [first - 1, first], name))
            cases.append(("split_ragged", (2, 2, 4099, d), [4098, 1366], name))
            cases.append(("split_first_of_many", (1, 1, 65536, d), [5], name))
    rows = []
    worst = {}
    for i, (kind, (b, h, m, d), positions, name) in enumerate(cases):
        q, k, v = attention_inputs(b, h, m, d, dtypes[name], seed=i)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        splits = da.split_plan(b, h, m, sms())
        out = da.decode_attention(q, k, v, pos)
        ref = da.decode_attention_reference(q, k, v, pos)
        split_ref = da.decode_attention_split_reference(q, k, v, pos, splits)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        split_err = (out.float() - split_ref.float()).abs().max().item()
        rows.append({"case": kind, "shape": [b, h, m, d], "pos": positions, "splits": splits,
                     "dtype": name, "max_abs_err": err, "max_abs_err_vs_split_plain": split_err,
                     "tol": tol[name]})
        worst[name] = max(worst.get(name, 0.0), err)
        if not (err < tol[name] and split_err < tol[name]) or out.dtype != q.dtype:
            raise AssertionError(f"decode_attention disagrees with its plain version: {rows[-1]}")

    # junk in the unwritten tail (slots > pos) must not leak into the output
    for name, dtype in dtypes.items():
        q, k, v = attention_inputs(1, 2, 96, 32, dtype, seed=100)
        pos = torch.tensor([40], dtype=torch.int32, device="cuda")
        base = da.decode_attention(q, k, v, pos)
        k[:, :, 41:] = 1e4
        v[:, :, 41:] = -1e4
        junk = da.decode_attention(q, k, v, pos)
        err = (base.float() - junk.float()).abs().max().item()
        rows.append({"case": "junk_tail", "shape": [1, 2, 96, 32], "pos": [40],
                     "dtype": name, "max_abs_err": err, "tol": 0.0})
        if err != 0.0:
            raise AssertionError(f"cache tail leaked into the output: {rows[-1]}")
        # pos 0 attends one slot: the output is v[:, :, 0]
        zero = da.decode_attention(q, k, v, torch.zeros(1, dtype=torch.int32, device="cuda"))
        err = (zero.float() - v[:, :, 0].float()).abs().max().item()
        rows.append({"case": "pos_zero", "shape": [1, 2, 96, 32], "pos": [0],
                     "dtype": name, "max_abs_err": err, "tol": tol[name]})
        if not err < tol[name]:
            raise AssertionError(f"pos 0 is not v[:, :, 0]: {rows[-1]}")
    return rows, worst


def time_decode_attention(shape, positions, iters):
    """Kernel, plain version and the SDPA yardstick on the same bf16 inputs."""
    b, h, m, d = shape
    q, k, v = attention_inputs(b, h, m, d, torch.bfloat16, seed=7)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    out = da.decode_attention(q, k, v, pos)
    ref = da.decode_attention_reference(q, k, v, pos)
    err = (out.float() - ref.float()).abs().max().item()
    if not err < TOLERANCE["decode_attention"]["bfloat16"]:
        raise AssertionError(f"decode_attention {shape} pos {positions}: error {err}")
    mask = (torch.arange(m, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    row = {
        "shape": list(shape), "pos": positions, "dtype": "bfloat16",
        "splits": da.split_plan(b, h, m, sms()),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: da.decode_attention(q, k, v, pos), iters),
        # both phases' device time per call (profiler)
        "device_ms": device_ms_per_call(lambda: da.decode_attention(q, k, v, pos),
                                        "decode_attention_", 20),
        "plain_ms": cuda_ms(lambda: da.decode_attention_reference(q, k, v, pos),
                            max(iters // 4, 3)),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask), iters),
        "bound_ms": attention_bound_ms(b, h, m, d, positions, 2, "bfloat16"),
    }
    return row


def flash_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))


def flash_agrees(out, ref, atol, rtol=None):
    """(max |out - ref|, every element within atol + rtol * |ref|; rtol =
    atol unless given)."""
    rtol = atol if rtol is None else rtol
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * ref.float().abs()).all())


def flash_bound(shape, causal, dtype_name):
    """Least time and what sets it: q, k, v read once and the output written
    once over the HBM rate, or 4*B*H*D flops per live (query, key) pair over
    the dtype's peak (S(S+1)/2 pairs when causal), whichever is larger."""
    b, s, h, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d
    nbytes = 4 * b * s * h * d * DTYPES[dtype_name].itemsize
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes else "bytes")


def check_flash_attention():
    """The kernel against the plain version at every listed shape and mode;
    one input per (shape, dtype, causal), so the block pairs must give the
    very same output."""
    cases = [("reference", (2, 128, 2, 32), "float32", causal, blocks)
             for causal in (False, True) for blocks in ((128, 128), (64, 32), (32, 64))]
    cases += [("ragged", (1, 100, 2, 16), "float32", causal, (64, 64)) for causal in (False, True)]
    cases += [("chip_bench", (4, 2048, 8, 128), "bfloat16", causal, (128, 128))
              for causal in (False, True)]
    cases += [("served", (1, s, 4, 16), "float32", False, (128, 128)) for s in (100, 4096, 8192)]
    # ragged lengths around the 64-row tiles, every D, both dtypes (the bf16
    # tensor-core kernel, the fp32 kernels for D <= 32 and D >= 64)
    cases += [("ragged_tiles", (2, s, 3, d), name, causal, (128, 128))
              for name in ("bfloat16", "float32") for d in (16, 32, 64, 128)
              for s in (1, 63, 65, 130) for causal in (False, True)]
    rows = []
    first = {}
    for kind, shape, name, causal, (bq, bk) in cases:
        q, k, v = flash_inputs(shape, DTYPES[name], seed=shape[1] + causal)
        out = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
        ref = flash_attention_reference(q, k, v, causal=causal)
        tiled = flash_attention_tiled_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = TOLERANCE["flash_attention"][name]
        err, ok = flash_agrees(out, ref, tol)
        # against the plain form of the kernel's loop (p rounded to v's dtype
        # before PV): in bf16 a gate of its own, far tighter than 2e-2
        tiled_err, tiled_ok = flash_agrees(out, tiled, TILED_TOLERANCE["atol"],
                                           TILED_TOLERANCE["rtol"])
        rows.append({"case": kind, "shape": list(shape), "dtype": name, "causal": causal,
                     "blocks": [bq, bk], "max_abs_err": err, "tol": tol,
                     "max_abs_err_vs_tiled_plain": tiled_err})
        if name == "bfloat16" and not tiled_ok:
            raise AssertionError(
                f"flash_attention disagrees with its tiled plain version: {rows[-1]}")
        if not ok or out.dtype != q.dtype or not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention disagrees with its plain version: {rows[-1]}")
        key = (shape, name, causal)
        if key in first and not torch.equal(first[key], out):
            raise AssertionError(f"flash_attention depends on its block arguments: {rows[-1]}")
        first.setdefault(key, out)
    return rows


def time_flash_attention(shape, name, causal, iters):
    """Kernel, plain version and the SDPA yardstick on the same inputs."""
    q, k, v = flash_inputs(shape, DTYPES[name], seed=99)
    out = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_reference(q, k, v, causal=causal)
    err, ok = flash_agrees(out, ref, TOLERANCE["flash_attention"][name])
    if not ok:
        raise AssertionError(f"flash_attention {shape} {name} causal={causal}: error {err}")
    # SDPA takes [B,H,S,D]: the transposes are views of the same inputs
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound_ms, bound_by = flash_bound(shape, causal, name)
    return {
        "shape": list(shape), "dtype": name, "causal": causal, "max_abs_err": err,
        "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=causal), iters),
        "plain_ms": cuda_ms(lambda: flash_attention_reference(q, k, v, causal=causal),
                            max(iters // 4, 3)),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def quantize_inputs(n, dtype, scale, seed):
    """Seeded normals spread past the clip range, with exact half-steps
    (k + 0.5) * scale, +-127.5 * scale and far-out values mixed in."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=gen, device="cuda") * (60 * scale)
    special = torch.cat([
        torch.arange(-130, 130, device="cuda", dtype=torch.float32) + 0.5,
        torch.tensor([127.5, -127.5, 1e4, -1e4, 0.0], device="cuda"),
    ]) * scale
    m = min(n, special.numel())
    x[torch.randperm(n, generator=gen, device="cuda")[:m]] = special[:m]
    return x.to(dtype)


def check_quantize():
    """quantize_int8 and dequantize_int8 element-exact against their plain
    versions. Quantize: fp32, bf16 and fp16 in, a power-of-two scale (exact
    half-steps after the multiply) and the example's max/127 scale, at the
    wire shape, a ragged length (the scalar tail), 64 MiB of fp32 and a
    view one element off 16-byte alignment (the scalar way), each
    dequantized back to its own dtype. Dequantize: fp32, bf16 and fp16 out
    over every int8 value, at the wire shape, a ragged length, one below
    and one above a whole word and a whole step of the largest grid (a word
    for every thread), 64 MiB, and with the input one byte off alignment
    (the scalar way; the wrapper allocates its output aligned)."""
    rows = []
    for name, dtype in FLOATS.items():
        for n in (8192, 8195, 16 * MIB, "unaligned"):
            for scale_kind in ("pow2", "fit"):
                base = quantize_inputs(8196 if n == "unaligned" else n, dtype, 2.0 ** -5,
                                       seed=len(rows))
                x = base[1:] if n == "unaligned" else base
                scale = 2.0 ** -5 if scale_kind == "pow2" else x.float().abs().max().item() / 127
                q = qz.quantize_int8(x, scale)
                q_ref = qz.quantize_int8_reference(x, scale)
                back = qz.dequantize_int8(q, scale, dtype)
                back_ref = qz.dequantize_int8_reference(q, scale, dtype)
                torch.cuda.synchronize()
                row = {"n": n, "dtype": name, "scale": scale,
                       "quantize_mismatches": int((q != q_ref).sum().item()),
                       "dequantize_mismatches": bit_mismatches(back, back_ref)}
                rows.append(row)
                if row["quantize_mismatches"] or row["dequantize_mismatches"]:
                    raise AssertionError(f"int8 kernels disagree with their plain versions: {row}")
    every = torch.arange(-128, 128, dtype=torch.int8, device="cuda")
    for name, dtype in FLOATS.items():
        word = qz.dequantize_plan(1, dtype, True).elements
        step = word * nz.THREADS * qz.dequantize_plan(1 << 40, dtype, True, sms()).blocks
        for n in (8192, 8195, word - 1, word + 1, step - 1, step + 1, 16 * MIB, "unaligned"):
            length = 8193 if n == "unaligned" else n
            gen = torch.Generator(device="cuda").manual_seed(length)
            q = torch.randint(-128, 128, (length,), generator=gen, device="cuda",
                              dtype=torch.int8)
            q[:min(256, length)] = every[:min(256, length)]
            q = q[1:] if n == "unaligned" else q
            rows.append(dequantize_case(q, 0.37, name, n))
    return rows


def dequantize_case(q, scale, out_name, n):
    """One dequantize_int8 call against its plain version; raises unless
    every element's bits agree."""
    out_dtype = FLOATS[out_name]
    out = qz.dequantize_int8(q, scale, out_dtype)
    ref = qz.dequantize_int8_reference(q, scale, out_dtype)
    torch.cuda.synchronize()
    row = {"n": n, "out": out_name, "aligned": q.data_ptr() % 16 == 0,
           "mismatches": bit_mismatches(out, ref)}
    if row["mismatches"] or out.dtype != out_dtype or out.shape != q.shape:
        raise AssertionError(f"dequantize_int8 disagrees with its plain version: {row}")
    return row


def check_ties():
    """Classification ties on the card: ``ops.topk_classification`` and the
    server's classification extension (batched) on tied rows, against the
    same calls on the CPU (ties lowest index first, as the CPU tests hold
    them to ``jax.lax.top_k``): int32 and float rows with ties across k,
    all-equal rows, bf16-rounded logits (densenet's logits are bf16) and
    rows of four values, rows without ties, and a batch where two rows of
    eight tie at their maximum. Beside each: how many rows ``torch.topk`` on the
    card gives in another order (recorded, not gated: the port does not
    call it)."""
    from client_tpu_torch.server.core import _classification

    gen = torch.Generator().manual_seed(40)
    tied = {
        "int32": torch.tensor([[1, 3, 3, 1, 3], [2, 2, 0, 2, 2]], dtype=torch.int32),
        "float": torch.tensor([[0.5, 2.0, 0.5, 2.0, 2.0, -1.0], [1.0, 0.0, 1.0, 1.0, 0.0, 1.0]]),
        "all_equal": torch.zeros(3, 8),
        "bf16_logits": (torch.randn(16, 1000, generator=gen) * 0.05).bfloat16().float(),
        "four_values": torch.randint(0, 4, (16, 1000), generator=gen, dtype=torch.int32),
        "distinct": torch.randn(64, 1000, generator=gen),
        "mixed": torch.randn(8, 1000, generator=gen),
    }
    for row, at in ((1, 7), (4, 900)):  # two rows whose maximum also stands elsewhere
        tied["mixed"][row, at] = tied["mixed"][row].max()
    rows = []
    for name, x in tied.items():
        for k in (1, 3, 5):
            k = min(k, x.shape[-1])
            values, indices = ops.topk_classification(x, k)
            dev_values, dev_indices = ops.topk_classification(x.to("cuda"), k)
            torch_topk = torch.topk(x.to("cuda"), k).indices.cpu()
            row = {"rows": name, "shape": list(x.shape), "k": k,
                   "equal": bool(torch.equal(dev_indices.cpu(), indices)
                                 and torch.equal(dev_values.cpu(), values)),
                   "strings_equal": (_classification(x.to("cuda"), k, None, True).tolist()
                                     == _classification(x, k, None, True).tolist()),
                   "torch_topk_rows_in_another_order": int((torch_topk != indices).any(-1)
                                                           .sum().item())}
            rows.append(row)
            if not (row["equal"] and row["strings_equal"]):
                raise AssertionError(f"classification ties rank otherwise on the card: {row}")
    return rows


def interleaved_ms(calls, rounds: int, batch: int):
    """Wall time per call of each of ``calls`` (name -> function): in each
    of ``rounds`` rounds every function runs ``batch`` calls and a
    synchronize, in an order rotated round by round, so the host clock's
    drift falls on all of them alike. Returns name -> the rounds' times,
    sorted."""
    names = list(calls)
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            t0 = time.perf_counter()
            for _ in range(batch):
                calls[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / batch * 1e3)
    return {name: sorted(t) for name, t in times.items()}


def time_classification(k: int = 5):
    """The classification extension's ranking on the card, fp32 logits,
    k = 5: ``ops.topk_classification`` (a stable sort cut to k) and
    ``torch.topk`` (its library call; it leaves the order of ties open),
    each alone and with its two copies to the host (the first is the
    extension's ranking, the second the one it had before it ranked ties
    as ``jax.lax.top_k``): wall time per call with the device drained
    (median and quartiles of interleaved rounds, ``interleaved_ms``) and
    the device time per call (profiler, every kernel and copy)."""
    from client_tpu_torch.server.core import _to_host

    gen = torch.Generator(device="cuda").manual_seed(41)
    rows = []
    for shape in ((1, VISION_CLASSES), (64, VISION_CLASSES), (16384, VISION_CLASSES)):
        x = torch.randn(shape, generator=gen, device="cuda")
        calls = {"sort": lambda: ops.topk_classification(x, k),
                 "torch_topk": lambda: torch.topk(x, k, dim=-1),
                 "sort_to_host": lambda: [_to_host(t) for t in ops.topk_classification(x, k)],
                 "topk_to_host": lambda: [_to_host(t) for t in torch.topk(x, k, dim=-1)]}
        row = {"shape": list(shape), "k": k}
        wall = interleaved_ms(calls, rounds=21, batch=50 if shape[0] <= 64 else 5)
        for name, fn in calls.items():
            t = wall[name]
            row[name] = {"ms": statistics.median(t), "ms_quartiles": [t[5], t[15]],
                         "device_ms": device_ms_per_call(fn, "", 20)}
        rows.append(row)
    return rows


def check_no_fallback():
    """A CUDA tensor of a dtype or head dim a kernel has no code for raises
    (TypeError or ValueError) and launches nothing: there is no fallback to
    the plain version. Then q, k and v views 2 or 4 bytes off 16-byte
    alignment run decode_attention and flash_attention on aligned copies,
    one launch each, within the plain versions' tolerance."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="cuda")

    half, pos = torch.float16, torch.zeros(1, dtype=torch.int32, device="cuda")
    cases = [
        ("normalize_image int16 in", lambda: ops.normalize_image(z(8, dtype=torch.int16)),
         TypeError),
        ("normalize_image bool in", lambda: ops.normalize_image(z(8, dtype=torch.bool)),
         TypeError),
        ("softmax_probabilities int32 in",
         lambda: ops.softmax_probabilities(z(2, 8, dtype=torch.int32)), TypeError),
        ("quantize_int8 int32 in", lambda: ops.quantize_int8(z(8, dtype=torch.int32), 1.0),
         TypeError),
        ("dequantize_int8 float32 in", lambda: ops.dequantize_int8(z(8), 1.0), TypeError),
        ("decode_attention float16", lambda: da.decode_attention(
            z(1, 1, 32, dtype=half), z(1, 1, 8, 32, dtype=half), z(1, 1, 8, 32, dtype=half),
            pos), TypeError),
        ("decode_attention D = 16", lambda: da.decode_attention(
            z(1, 1, 16), z(1, 1, 8, 16), z(1, 1, 8, 16), pos), ValueError),
        ("flash_attention float16", lambda: flash_attention(
            *(z(1, 8, 2, 16, dtype=half) for _ in range(3))), TypeError),
        ("flash_attention D = 8", lambda: flash_attention(*(z(1, 8, 2, 8) for _ in range(3))),
         ValueError),
    ]
    reset_counts()
    rows = []
    for name, call, exc in cases:
        try:
            call()
        except exc as e:
            rows.append({"case": name, "raised": type(e).__name__, "message": str(e)})
        else:
            raise AssertionError(f"{name}: ran where it should raise")
    if any(read_counts().values()):
        raise AssertionError(f"a refused call launched a kernel: {read_counts()}")

    def off(t, elements):
        """A contiguous copy of ``t`` starting ``elements`` past an aligned
        allocation."""
        view = torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")[elements:]
        return view[:t.numel()].view(t.shape).copy_(t)

    q, k, v = attention_inputs(2, 2, 300, 64, torch.bfloat16, seed=50)
    q, k, v = off(q, 1), off(k, 1), off(v, 1)
    positions = torch.tensor([40, 299], dtype=torch.int32, device="cuda")
    fq, fk, fv = (off(t, 1) for t in flash_inputs((1, 100, 2, 16), torch.float32, seed=51))
    checks = (
        ("decode_attention bf16 views 2 bytes off", da.LAUNCHES,
         lambda: da.decode_attention(q, k, v, positions),
         lambda: da.decode_attention_reference(q, k, v, positions),
         TOLERANCE["decode_attention"]["bfloat16"], (q, k, v)),
        ("flash_attention fp32 views 4 bytes off", FLASH_LAUNCHES,
         lambda: flash_attention(fq, fk, fv), lambda: flash_attention_reference(fq, fk, fv),
         TOLERANCE["flash_attention"]["float32"], (fq, fk, fv)),
    )
    for name, counter, kernel, plain, tol, views in checks:
        if not all(t.data_ptr() % 16 for t in views):
            raise AssertionError(f"{name}: the views are aligned")
        before = counter.count
        out = kernel()
        err = (out.float() - plain().float()).abs().max().item()
        row = {"case": name, "max_abs_err": err, "tol": tol,
               "launches": counter.count - before}
        rows.append(row)
        if not err < tol or row["launches"] != 1:
            raise AssertionError(f"{name} disagrees with its plain version: {row}")
    return rows


def quantize_library(x, scale, q):
    """``torch.quantize_per_tensor(x, scale, 0, torch.qint8)`` against the
    kernel's output ``q``: the count of int8 values that differ, and up to 8
    (kernel, library, x / scale) triples where they do. Its range is
    [-128, 127] where the kernel clips to +-127, and it may round x / scale
    where the kernel rounds x * f32(1 / scale)."""
    lib = torch.quantize_per_tensor(x, scale, 0, torch.qint8).int_repr()
    differ = (lib != q).nonzero().flatten()
    where = [(int(q.flatten()[i]), int(lib.flatten()[i]), x.flatten()[i].item() / scale)
             for i in differ[:8].tolist()]
    return int(differ.numel()), where


def time_quantize(n, iters):
    """Both kernels and their plain versions on n fp32 elements, beside the
    bytes bound. The yardstick for dequantize is ``q * scale``; for quantize
    ``torch.quantize_per_tensor(x, scale, 0, torch.qint8)``, whose int8
    values are counted against the kernel's on the timed input and, at n =
    8192, on the int8 wire path's own input: its time is ``library_ms``
    only where both give 0 mismatches. Each kernel and library call also
    has its device time (profiler) and, at n = 8192, its host time per
    call (enqueue, no sync). Beside dequantize at 16 Mi: the card's write
    ceiling, ``out.fill_(1.0)`` on as many fp32 elements (never called by
    the port)."""
    x = quantize_inputs(n, torch.float32, 0.03, seed=5)
    scale = x.abs().max().item() / 127
    q = qz.quantize_int8(x, scale)
    q_err = (q.int() - qz.quantize_int8_reference(x, scale).int()).abs().max().item()
    d_err = (qz.dequantize_int8(q, scale)
             - qz.dequantize_int8_reference(q, scale)).abs().max().item()
    if q_err or d_err:
        raise AssertionError(f"int8 kernels disagree at n = {n}: {q_err}, {d_err}")
    bound_ms = (4 * n + n) / PEAK_BYTES_PER_S * 1e3  # fp32 in/out, int8 out/in
    mismatches, where = quantize_library(x, scale, q)
    library = {"library_mismatches": mismatches, "library_mismatch_at": where}
    if n == 8192:
        wire = torch.from_numpy(np.random.default_rng(11).standard_normal((1, n)).astype(
            np.float32)).to("cuda")
        wire_scale = wire.abs().max().item() / 127
        library["library_mismatches_wire"], library["library_mismatch_at_wire"] = (
            quantize_library(wire, wire_scale, qz.quantize_int8(wire, wire_scale)))
    library["library_candidate_ms"] = cuda_ms(
        lambda: torch.quantize_per_tensor(x, scale, 0, torch.qint8), iters)
    exact = mismatches == 0 and library.get("library_mismatches_wire", 0) == 0
    calls = {  # kernel, its name in the profiler, plain version, library call, error
        "quantize": (lambda: qz.quantize_int8(x, scale), "::quantize_kernel",
                     lambda: qz.quantize_int8_reference(x, scale),
                     lambda: torch.quantize_per_tensor(x, scale, 0, torch.qint8), q_err),
        "dequantize": (lambda: qz.dequantize_int8(q, scale), "::dequantize_kernel",
                       lambda: qz.dequantize_int8_reference(q, scale), lambda: q * scale,
                       d_err),
    }
    row = {"n": n, "bytes_fp32": 4 * n, "scale": scale}
    for name, (kernel, kernel_name, plain, lib, err) in calls.items():
        row[name] = {
            "ms": cuda_ms(kernel, iters),
            "device_ms": device_ms_per_launch(kernel, kernel_name, 20),
            "plain_ms": cuda_ms(plain, iters),
            "library_device_ms": device_ms_per_call(lib, "", 20),
            "bound_ms": bound_ms, "max_abs_err": err}
        device_share(row[name])
        if n == 8192:
            row[name]["host_us"] = host_us(kernel)
            row[name]["library_host_us"] = host_us(lib)
    row["quantize"].update(library, library_ms=library["library_candidate_ms"] if exact else None)
    row["dequantize"]["library_ms"] = cuda_ms(lambda: q * scale, iters)
    if n >= 16 * MIB:
        out = torch.empty(n, dtype=torch.float32, device="cuda")
        row["dequantize"]["write_ceiling"] = {
            "call": "out.fill_(1.0), fp32", "n": n,
            "ms": cuda_ms(lambda: out.fill_(1.0), iters),
            "device_ms": device_ms_per_call(lambda: out.fill_(1.0), "", 20),
            "bound_ms": 4 * n / PEAK_BYTES_PER_S * 1e3}
        device_share(row["dequantize"]["write_ceiling"])
    return row


def time_dequantize_to(n, out_dtype, iters):
    """dequantize_int8 to a 2-byte type at n elements: kernel, plain
    version and ``torch.mul(q, scale, out=o)`` with a bf16 or fp16 ``o``
    (one call: it multiplies in float32 and rounds to o's type, whose bits
    are counted against the kernel's, not assumed), per call and on the
    device (profiler), beside the bytes bound (n int8 in, 2n bytes out)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randint(-128, 128, (n,), generator=gen, device="cuda", dtype=torch.int8)
    scale = 0.37
    out = qz.dequantize_int8(q, scale, out_dtype)
    if bit_mismatches(out, qz.dequantize_int8_reference(q, scale, out_dtype)):
        raise AssertionError(f"dequantize_int8 to {out_dtype} disagrees at n = {n}")
    lib_out = torch.empty(n, dtype=out_dtype, device="cuda")

    def kernel():
        return qz.dequantize_int8(q, scale, out_dtype)

    def library():
        return torch.mul(q, scale, out=lib_out)

    library()
    mismatches = bit_mismatches(lib_out, out)
    candidate = cuda_ms(library, iters)
    row = {
        "n": n, "out": str(out_dtype).replace("torch.", ""), "max_abs_err": 0.0,
        "ms": cuda_ms(kernel, iters),
        "device_ms": device_ms_per_launch(kernel, "::dequantize_kernel", 20),
        "plain_ms": cuda_ms(lambda: qz.dequantize_int8_reference(q, scale, out_dtype), iters),
        "bound_ms": 3 * n / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_mismatches": mismatches, "library_candidate_ms": candidate,
        "library_device_ms": device_ms_per_call(library, "", 20),
        "library_ms": candidate if mismatches == 0 else None,
    }
    device_share(row)
    return row


INCEPTION = (2.0 / 255.0, -1.0)
NORMALIZE_IN = {"float32": torch.float32, "uint8": torch.uint8, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32}


def image_input(shape, dtype, seed):
    """Seeded pixel values 0..255 (uniform reals, truncated for uint8)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=gen, device="cuda") * 255
    return x.to(torch.uint8) if dtype == torch.uint8 else x.to(dtype)


def bit_mismatches(a, b) -> int:
    """Elements whose bits differ (same dtype and shape)."""
    ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return int((a.view(ints) != b.view(ints)).sum().item())


def check_normalize():
    """normalize_image element-exact against its plain version: fp32, uint8,
    bf16, fp16 and int32 in x fp32, bf16 and fp16 out, INCEPTION and NONE
    scaling, at the image_client's (224, 224, 3), a ragged (7, 13, 3), 64
    MiB of fp32 and an input one element off 16-byte alignment (the
    kernel's scalar path), and int32 spread past 2**24 (where its fp32 cast
    rounds); then, for every path (the widening uint8 -> fp32 / bf16 / fp16
    and bf16 -> fp32 among them), at lengths one below and one above a
    whole vector (the word a thread takes at a time) and a whole step of the
    largest grid (a word for every thread), where the word loop, its
    grid-stride step and the scalar tail meet."""
    rows = []
    for in_name, in_dtype in NORMALIZE_IN.items():
        for shape in ((224, 224, 3), (7, 13, 3), (16 * MIB,), "unaligned"):
            base = image_input((4099,) if shape == "unaligned" else shape, in_dtype,
                               seed=len(rows))
            x = base[1:] if shape == "unaligned" else base
            for out_name in FLOATS:
                for mode, (scale, shift) in (("INCEPTION", INCEPTION), ("NONE", (1.0, 0.0))):
                    rows.append(normalize_case(x, shape, in_name, out_name, mode, scale,
                                               shift))
    gen = torch.Generator(device="cuda").manual_seed(24)
    wide = torch.randint(-2 ** 31, 2 ** 31 - 1, (8195,), generator=gen, device="cuda",
                         dtype=torch.int32)
    for out_name in FLOATS:
        rows.append(normalize_case(wide, (8195,), "int32 past 2**24", out_name, "odd", 0.37,
                                   0.5))
    plan = nz.normalize_plan
    for in_name, in_dtype in NORMALIZE_IN.items():
        for out_name, out_dtype in FLOATS.items():
            vector = plan(1, in_dtype, out_dtype, True).elements
            step = vector * nz.THREADS * plan(1 << 40, in_dtype, out_dtype, True, sms()).blocks
            for n in (vector - 1, vector + 1, step - 1, step + 1):
                x = image_input((n,), in_dtype, seed=n)
                rows.append(normalize_case(x, (n,), in_name, out_name, "INCEPTION",
                                           *INCEPTION))
    return rows


def normalize_case(x, shape, in_name, out_name, mode, scale, shift):
    """One normalize_image call against its plain version; raises unless
    every element's bits agree."""
    out_dtype = FLOATS[out_name]
    out = ops.normalize_image(x, scale, shift, out_dtype)
    ref = nz.normalize_image_reference(x, scale, shift, out_dtype)
    torch.cuda.synchronize()
    row = {"shape": shape if isinstance(shape, str) else list(shape), "in": in_name,
           "out": out_name, "mode": mode, "mismatches": bit_mismatches(out, ref)}
    if row["mismatches"] or out.dtype != out_dtype or out.shape != x.shape:
        raise AssertionError(f"normalize_image disagrees with its plain version: {row}")
    return row


def time_normalize(shape, in_dtype, iters):
    """Kernel and plain version (INCEPTION, fp32 out) beside the bytes bound.
    The yardstick ``torch.add(shift, x, alpha=scale)`` computes x * scale +
    shift in one call (the 0-dim fp32 ``shift`` makes a uint8 ``x`` give
    float32 too); whether it gives the kernel's single rounding is counted,
    not assumed. Kernel and yardstick each have their device time
    (profiler) and, below 1 Mi elements, their host time per call (enqueue,
    no sync)."""
    x = image_input(shape, in_dtype, seed=3)
    scale, shift = INCEPTION
    out = ops.normalize_image(x, scale, shift, torch.float32)
    err = bit_mismatches(out, nz.normalize_image_reference(x, scale, shift, torch.float32))
    if err:
        raise AssertionError(f"normalize_image {shape} {in_dtype}: {err} mismatches")
    n = x.numel()
    shift_t = torch.tensor(shift, device="cuda")

    def kernel():
        return ops.normalize_image(x, scale, shift, torch.float32)

    def library():
        return torch.add(shift_t, x, alpha=scale)

    row = {
        "shape": list(shape), "in": str(in_dtype).replace("torch.", ""), "out": "float32",
        "max_abs_err": 0.0,
        "ms": cuda_ms(kernel, iters),
        "device_ms": device_ms_per_launch(kernel, "normalize_kernel", 20),
        "plain_ms": cuda_ms(lambda: nz.normalize_image_reference(x, scale, shift,
                                                                 torch.float32), iters),
        "bound_ms": n * (x.element_size() + 4) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
    }
    device_share(row)
    lib = library()
    if lib.dtype != torch.float32:
        raise AssertionError(f"torch.add(shift, x, alpha=scale) gave {lib.dtype} for {in_dtype}")
    row["library_mismatches"] = bit_mismatches(lib, out)
    row["library_candidate_ms"] = cuda_ms(library, iters)
    row["library_device_ms"] = device_ms_per_call(library, "", 20)
    if row["library_mismatches"] == 0:
        row["library_ms"] = row["library_candidate_ms"]
    if n < MIB:
        row["host_us"] = host_us(kernel)
        row["library_host_us"] = host_us(library)
    return row


def check_softmax():
    """softmax_probabilities against its plain version within rtol 1e-5
    (atol 1e-30): the served (1, 1000), a batch (8, 1000), tests/
    test_utils.py's (3, 50) x 30, 1-D (1000,), bf16 (8, 1000), a long row
    (4, 5000), a bytes-sized (16384, 1000), fp16 (8, 1000); then every
    width in SOFTMAX_COLS at 1, 8 and 16384 rows in fp32, bf16 and fp16
    (every variant of softmax_plan and every warps and vectors count it
    picks, which must all occur), and a row 4 bytes off 16-byte
    alignment. Special rows (all -inf,
    a -inf prefix, a NaN, a +inf) in each variant must give what the plain
    version gives (NaN where it does)."""
    from client_tpu_torch.ops.softmax import softmax_plan

    rows = []
    cases = [((1, 1000), "float32", 1.0), ((8, 1000), "float32", 1.0),
             ((3, 50), "float32", 30.0), ((1000,), "float32", 1.0),
             ((8, 1000), "bfloat16", 1.0), ((4, 5000), "float32", 1.0),
             ((16384, 1000), "float32", 1.0), ((8, 1000), "float16", 1.0)]
    cases += [((r, c), name, 4.0) for name in FLOATS for r in (1, 8, 16384)
              for c in SOFTMAX_COLS]
    cases.append(("unaligned", "float32", 4.0))
    seen = set()
    for i, (shape, name, stretch) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(i)
        if shape == "unaligned":
            x = (torch.randn(8 * 1000 + 1, generator=gen, device="cuda") * stretch)[1:]
            x = x.view(8, 1000)
        else:
            x = (torch.randn(shape, generator=gen, device="cuda") * stretch).to(FLOATS[name])
        cols = x.shape[-1]
        plan = softmax_plan(x.numel() // cols, cols, x.dtype, x.data_ptr() % 16 == 0, sms())
        seen.update({("variant", plan.variant), ("warps", plan.warps),
                     (f"vectors {name}", plan.vectors if plan.variant == "registers" else 0)})
        rows.append(softmax_case(x, shape, name, stretch, plan))
    want = ({("variant", v) for v in ("registers", "two_pass", "scalar")}
            | {("warps", w) for w in (1, 2, 4, 8)}
            | {("vectors float32", v) for v in (1, 2, 4, 8)}
            | {(f"vectors {name}", v) for name in ("bfloat16", "float16") for v in (1, 2, 4)})
    if want - seen:
        raise AssertionError(f"softmax checks never ran {sorted(want - seen)}")
    inf, nan = float("inf"), float("nan")
    for cols in (8, SOFTMAX_COLS[-1], SOFTMAX_COLS[-3]):  # registers, two_pass, scalar
        x = torch.randn((5, cols), generator=torch.Generator().manual_seed(cols))
        x[0] = -inf
        x[1, : cols // 2 + 1] = -inf
        x[2, cols // 3] = nan
        x[3, cols - 1] = inf
        x = x.to("cuda")
        plan = softmax_plan(5, cols, x.dtype, True, sms())
        out = ops.softmax_probabilities(x)
        ref = sm.softmax_probabilities_reference(x)
        tol = TOLERANCE["softmax_probabilities"]
        if not torch.allclose(out, ref, rtol=tol["rtol"], atol=tol["atol"], equal_nan=True):
            raise AssertionError(f"softmax_probabilities of special rows ({plan}) differs: "
                                 f"{out[:, :4]} vs {ref[:, :4]}")
        rows.append({"shape": [5, cols], "dtype": "float32", "scale": 1.0,
                     "case": "special rows: -inf, a -inf prefix, NaN, +inf",
                     "variant": plan.variant, "warps": plan.warps, "vectors": plan.vectors,
                     "nan_rows": int(out.isnan().all(-1).sum().item())})
    return rows


# softmax widths that reach every variant: whole rows in registers up to
# REGISTER_COLS (8192; one warp or several, 1-8 vectors a thread), scalar
# where a row is not a whole number of 16-byte vectors (1, 3, 2049, 8193;
# in bf16 also 8196), two passes one bf16 vector past the register width
SOFTMAX_COLS = (1, 3, 8, 1000, 1024, 2048, 2049, 4096, 5000, 8192, 8193, 8196, 8200)


def softmax_case(x, shape, name, stretch, plan):
    """One softmax_probabilities call against its plain version; raises
    unless every probability is within rtol 1e-5 (atol 1e-30)."""
    tol = TOLERANCE["softmax_probabilities"]
    out = ops.softmax_probabilities(x)
    ref = sm.softmax_probabilities_reference(x)
    torch.cuda.synchronize()
    rel = ((out - ref).abs() / ref.abs().clamp_min(tol["atol"])).max().item()
    row = {"shape": shape if isinstance(shape, str) else list(shape), "dtype": name,
           "scale": stretch, "variant": plan.variant, "warps": plan.warps,
           "vectors": plan.vectors, "max_rel_err": rel,
           "max_abs_err": (out - ref).abs().max().item(), "rtol": tol["rtol"]}
    if (out.dtype != torch.float32 or out.shape != x.shape
            or not torch.allclose(out, ref, rtol=tol["rtol"], atol=tol["atol"])):
        raise AssertionError(f"softmax_probabilities disagrees with its plain version: {row}")
    return row


def time_softmax(shape, iters):
    """Kernel, plain version and ``torch.softmax(x, -1, dtype=float32)``
    beside the bytes bound (each logit read once, each probability written
    once, fp32): per call (CUDA events), on the device (profiler) and, at
    one row, on the host per call (enqueue, no sync)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(shape, generator=gen, device="cuda") * 4
    out = ops.softmax_probabilities(x)
    ref = sm.softmax_probabilities_reference(x)
    tol = TOLERANCE["softmax_probabilities"]
    if not torch.allclose(out, ref, rtol=tol["rtol"], atol=tol["atol"]):
        raise AssertionError(f"softmax_probabilities {shape} disagrees with its plain version")

    def kernel():
        return ops.softmax_probabilities(x)

    def library():
        return torch.softmax(x, -1, dtype=torch.float32)

    row = {
        "shape": list(shape), "dtype": "float32",
        "max_abs_err": (out - ref).abs().max().item(),
        "ms": cuda_ms(kernel, iters),
        "device_ms": device_ms_per_launch(kernel, "softmax_", 20),
        "plain_ms": cuda_ms(lambda: sm.softmax_probabilities_reference(x), iters),
        "library_ms": cuda_ms(library, iters),
        "library_device_ms": device_ms_per_call(library, "", 20),
        "bound_ms": 8 * x.numel() / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    device_share(row)
    if shape[0] == 1:
        row["host_us"] = host_us(kernel)
        row["library_host_us"] = host_us(library)
    return row


def profiled_kernels(fn, kernel_name, runs):
    """The kernels whose names hold ``kernel_name`` in a torch.profiler
    trace of ``runs`` calls of ``fn``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return [k for k in device_kernels(prof) if kernel_name in k["name"]]


def device_ms_per_call(fn, kernel_name, runs):
    """Device time per call of ``fn`` in the kernels named ``kernel_name``
    (every phase a call launches); None if the trace has none."""
    hits = profiled_kernels(fn, kernel_name, runs)
    return sum(k["total_ms"] for k in hits) / runs if hits else None


def device_ms_per_launch(fn, kernel_name, runs):
    """Device time alone per launch of the kernel named ``kernel_name``
    over ``runs`` calls of ``fn`` (the CUDA event time of back-to-back
    wrapper calls includes the host's launch cost, which dominates at small
    sizes); None if the trace has none."""
    hits = profiled_kernels(fn, kernel_name, runs)
    launches = sum(k["count"] for k in hits)
    return sum(k["total_ms"] for k in hits) / launches if launches else None


# ---------------------------------------------------------------------------
# phase 4: the served path
# ---------------------------------------------------------------------------


def p50_ms(fn, iters: int) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def drive_identity(client, nbytes: int, iters: int, mod=httpclient):
    """identity_fp32 over the wire, system shm and colocated cuda shm, through
    ``client`` of the client module ``mod`` (HTTP or GRPC)."""
    n = nbytes // 4
    shape = [1, n]
    x = torch.arange(n, dtype=torch.float32, device="cuda").reshape(shape) * 0.5
    x_host = x.cpu().numpy()
    row = {"bytes": nbytes}

    def wire():
        inp = mod.InferInput("INPUT0", shape, "FP32").set_data_from_numpy(x_host)
        return client.infer("identity_fp32", [inp]).as_numpy("OUTPUT0")

    if not np.array_equal(wire(), x_host):
        raise AssertionError("identity_fp32 over the wire changed the tensor")
    row["wire_p50_ms"] = p50_ms(wire, iters)

    tag = os.urandom(4).hex()
    sys_in = shm.create_shared_memory_region(f"sin{tag}", f"/sin{tag}", nbytes)
    sys_out = shm.create_shared_memory_region(f"sout{tag}", f"/sout{tag}", nbytes)
    try:
        client.register_system_shared_memory(f"sin{tag}", f"/sin{tag}", nbytes)
        client.register_system_shared_memory(f"sout{tag}", f"/sout{tag}", nbytes)

        def system():
            shm.set_shared_memory_region(sys_in, [x_host])
            inp = mod.InferInput("INPUT0", shape, "FP32").set_shared_memory(f"sin{tag}", nbytes)
            out = mod.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory(f"sout{tag}", nbytes)
            client.infer("identity_fp32", [inp], outputs=[out])
            return shm.get_contents_as_numpy(sys_out, "FP32", shape)

        if not np.array_equal(system(), x_host):
            raise AssertionError("identity_fp32 over system shm changed the tensor")
        row["system_shm_p50_ms"] = p50_ms(system, iters)
    finally:
        client.unregister_system_shared_memory()
        shm.destroy_shared_memory_region(sys_in)
        shm.destroy_shared_memory_region(sys_out)

    cu_in = cudashm.create_shared_memory_region(f"cin{tag}", nbytes, colocated=True)
    cu_out = cudashm.create_shared_memory_region(f"cout{tag}", nbytes, colocated=True)
    try:
        client.register_cuda_shared_memory(f"cin{tag}", cudashm.get_raw_handle(cu_in), 0, nbytes)
        client.register_cuda_shared_memory(f"cout{tag}", cudashm.get_raw_handle(cu_out), 0, nbytes)

        def cuda():
            cudashm.set_shared_memory_region_from_torch(cu_in, x)
            inp = mod.InferInput("INPUT0", shape, "FP32").set_shared_memory(f"cin{tag}", nbytes)
            out = mod.InferRequestedOutput("OUTPUT0")
            out.set_shared_memory(f"cout{tag}", nbytes)
            client.infer("identity_fp32", [inp], outputs=[out])
            return cudashm.get_contents_as_torch(cu_out, "FP32", shape)

        y = cuda()
        # the model got the client's CUDA tensor itself and handed it back
        if not (y.is_cuda and y.data_ptr() == x.data_ptr() and torch.equal(y, x)):
            raise AssertionError("cuda shm did not hand the CUDA tensor through")
        row["cuda_shm_p50_ms"] = p50_ms(cuda, iters)
        # colocated regions never mirror to the host: both windows stay zero
        for region in (cu_in, cu_out):
            if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(cu_in)
        cudashm.destroy_shared_memory_region(cu_out)
    return row


def drive_long_context(client, cpu_model, seqs, iters):
    """long_context_encoder over the wire and colocated cuda shm at each
    sequence length, every output against the CPU run of the port with the
    same weights (flash_attention's fp32 tolerance). Returns the rows and
    the number of requests made."""
    dim = cpu_model.encoder.dim
    tol = TOLERANCE["flash_attention"]["float32"]
    tag = os.urandom(4).hex()
    rows, requests = [], 0
    for seq in seqs:
        gen = torch.Generator(device="cuda").manual_seed(seq)
        x = torch.randn((seq, dim), generator=gen, device="cuda")
        x_host = x.cpu().numpy()
        want = cpu_model.execute({"sequence": x_host}, {})["encoded"].numpy()
        nbytes = seq * dim * 4
        row = {"seq": seq, "dim": dim, "heads": cpu_model.encoder.heads}

        def check(got, plane):
            ok = (got.shape == want.shape and np.isfinite(got).all()
                  and np.allclose(got, want, atol=tol, rtol=tol))
            row[f"{plane}_max_abs_diff_vs_cpu"] = float(np.abs(got - want).max())
            if not ok:
                raise AssertionError(f"long_context_encoder over {plane} differs from the "
                                     f"CPU run: {row}")

        def wire():
            inp = httpclient.InferInput("sequence", [seq, dim], "FP32").set_data_from_numpy(x_host)
            return client.infer("long_context_encoder", [inp]).as_numpy("encoded")

        check(wire(), "wire")
        row["wire_p50_ms"] = p50_ms(wire, iters)
        requests += 1 + iters

        names = (f"lcin{tag}{seq}", f"lcout{tag}{seq}")
        cu_in, cu_out = (cudashm.create_shared_memory_region(n, nbytes, colocated=True)
                         for n in names)
        try:
            for name, region in zip(names, (cu_in, cu_out)):
                client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0,
                                                   nbytes)

            def cuda():
                cudashm.set_shared_memory_region_from_torch(cu_in, x)
                inp = httpclient.InferInput("sequence", [seq, dim], "FP32").set_shared_memory(
                    names[0], nbytes)
                out = httpclient.InferRequestedOutput("encoded")
                out.set_shared_memory(names[1], nbytes)
                client.infer("long_context_encoder", [inp], outputs=[out])
                y = cudashm.get_contents_as_torch(cu_out, "FP32", [seq, dim])
                torch.cuda.synchronize()  # the output is ready to use
                return y

            y = cuda()
            if not y.is_cuda:
                raise AssertionError("long_context_encoder's cuda shm output left the card")
            check(y.cpu().numpy(), "cuda_shm")
            row["cuda_shm_p50_ms"] = p50_ms(cuda, iters)
            requests += 1 + iters
            for region in (cu_in, cu_out):
                if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                    raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
        finally:
            client.unregister_cuda_shared_memory()
            cudashm.destroy_shared_memory_region(cu_in)
            cudashm.destroy_shared_memory_region(cu_out)
        rows.append(row)
    return rows, requests


def drive_int8(client, rounds):
    """examples/quantized_wire_client.py with the port: quantize on the
    card, INT8 over the wire through identity_int8, dequantize on the card;
    the error must be within half a step. Returns the row and the number of
    round trips made."""
    x_host = np.random.default_rng(11).standard_normal((1, 8192)).astype(np.float32)
    scale = float(np.abs(x_host).max() / 127.0)
    x = torch.from_numpy(x_host).to("cuda")

    def round_trip():
        q = qz.quantize_int8(x, scale)
        inp = httpclient.InferInput("INPUT0", list(q.shape), "INT8")
        inp.set_data_from_numpy(q.cpu().numpy())
        q_back = client.infer("identity_int8", [inp]).as_numpy("OUTPUT0")
        restored = qz.dequantize_int8(numpy_to_tensor(q_back, "cuda"), scale)
        torch.cuda.synchronize()
        return q, q_back, restored

    q, q_back, restored = round_trip()
    err = (restored - x).abs().max().item()
    row = {"shape": list(x.shape), "scale": scale, "max_abs_err": err, "bound": scale / 2,
           "wire_bytes": int(q.numel()), "fp32_bytes": int(x.numel() * 4)}
    if (q_back.dtype != np.int8 or not np.array_equal(q_back, q.cpu().numpy())
            or not err <= scale / 2 + 1e-6):
        raise AssertionError(f"int8 wire path failed: {row}")
    row["p50_ms"] = p50_ms(round_trip, rounds)
    return row, rounds + 1


VISION_CLASSES, VISION_WIDTH = 1000, 96


def top_entries(result, name):
    """The classification extension's "value:index:label" entries."""
    return [e.decode().split(":") for e in result.as_numpy(name).reshape(-1)]


def serve_vision(iters):
    """The vision path on the card: ``build_image_ensemble`` at width 96 /
    1000 classes (weights from seed 0) behind the port's HTTP server, driven
    by the port's client, against a CPU run of the port with the same
    weights. Each flow runs with every launch count set to 0 just before it
    and read just after:

    - image_client: the noise image to the card, ``ops.normalize_image``
      (INCEPTION), CHW, ``densenet_onnx`` (a) over the wire and (b) through
      colocated cuda shm for data_0 and fc6_1, then
      ``ops.softmax_probabilities`` on the logits in the output region;
    - ensemble_image: (300, 400, 3) UINT8 noise over the wire.
    """
    models = build_image_ensemble(VISION_CLASSES, VISION_WIDTH, device="cuda")
    densenet = models[1]
    cpu_densenet = DenseNetModel(VISION_CLASSES, VISION_WIDTH, seed=0, device="cpu")
    server = HttpInferenceServer(ServerCore(models)).start()
    client = httpclient.InferenceServerClient(server.url, network_timeout=600.0)
    img = np.random.default_rng(0).uniform(0, 255, (224, 224, 3)).astype(np.float32)
    raw = np.random.default_rng(0).integers(0, 256, (300, 400, 3)).astype(np.uint8)
    scale, shift = INCEPTION
    in_bytes, out_bytes = 3 * 224 * 224 * 4, VISION_CLASSES * 4
    calls = {"image_client": 0, "ensemble": 0, "softmax": 0}
    result = {"classes": VISION_CLASSES, "width": VISION_WIDTH,
              "flops_per_image": flops_per_image(VISION_CLASSES, VISION_WIDTH, (2, 2, 2))}

    def data_0():
        """image_client's preprocess on the card: HWC -> INCEPTION -> CHW."""
        calls["image_client"] += 1
        x = torch.from_numpy(img).to("cuda")
        return ops.normalize_image(x, scale, shift, torch.float32).permute(2, 0, 1).contiguous()

    def wire(class_count=0):
        inp = httpclient.InferInput("data_0", [3, 224, 224], "FP32").set_data_from_numpy(data_0())
        out = httpclient.InferRequestedOutput("fc6_1", class_count=class_count)
        return client.infer("densenet_onnx", [inp], outputs=[out])

    def ensemble(class_count=0):
        calls["ensemble"] += 1
        inp = httpclient.InferInput("IMAGE", list(raw.shape), "UINT8").set_data_from_numpy(raw)
        out = httpclient.InferRequestedOutput("CLASSIFICATION", class_count=class_count)
        return client.infer("ensemble_image", [inp], outputs=[out])

    # the CPU reference: the same seed-0 weights, the plain normalize
    want = cpu_densenet.execute({"data_0": nz.normalize_image_reference(
        torch.from_numpy(img), scale, shift, torch.float32).permute(2, 0, 1).contiguous()},
        {})["fc6_1"].numpy().reshape(-1)
    stage0 =ImagePreprocessModel(device="cpu").execute({"raw_image": raw}, {})["preprocessed"]
    want_ens = cpu_densenet.execute({"data_0": stage0}, {})["fc6_1"].numpy().reshape(-1)
    # the gRPC phase holds its image_client flow against the same CPU run
    result["cpu_logits"] = want.tolist()

    def check(logits, reference, what):
        diff = float(np.abs(logits - reference).max())
        result[f"{what}_max_abs_logit_diff_vs_cpu"] = diff
        if (logits.shape != reference.shape or not np.isfinite(logits).all() or diff > 5e-2
                or logits.argmax() != reference.argmax()):
            raise AssertionError(f"{what}: logits differ from the CPU run by {diff} (top-1 "
                                 f"{logits.argmax()} vs {reference.argmax()})")

    def check_top(entries, reference, what):
        result[f"{what}_top3"] = entries
        if (len(entries) != 3 or int(entries[0][1]) != int(reference.argmax())
                or entries[0][2] != f"class_{entries[0][1]}"):
            raise AssertionError(f"{what}: top-3 {entries}, CPU top-1 {reference.argmax()}")

    tag = os.urandom(4).hex()
    names = (f"dnin{tag}", f"dnout{tag}")
    cu_in = cudashm.create_shared_memory_region(names[0], in_bytes, colocated=True)
    cu_out = cudashm.create_shared_memory_region(names[1], out_bytes, colocated=True)
    try:
        client.register_cuda_shared_memory(names[0], cudashm.get_raw_handle(cu_in), 0, in_bytes)
        client.register_cuda_shared_memory(names[1], cudashm.get_raw_handle(cu_out), 0,
                                           out_bytes)

        def cuda():
            cudashm.set_shared_memory_region_from_torch(cu_in, data_0())
            inp = httpclient.InferInput("data_0", [3, 224, 224], "FP32").set_shared_memory(
                names[0], in_bytes)
            out = httpclient.InferRequestedOutput("fc6_1")
            out.set_shared_memory(names[1], out_bytes)
            client.infer("densenet_onnx", [inp], outputs=[out])
            logits = cudashm.get_contents_as_torch(cu_out, "FP32", [VISION_CLASSES, 1, 1])
            calls["softmax"] += 1
            probs = ops.softmax_probabilities(logits.reshape(1, VISION_CLASSES))
            torch.cuda.synchronize()  # the probabilities are ready to use
            return logits, probs

        # one request of each flow first (cuDNN and library set-up, the kernel
        # libraries loaded), outside the counts
        wire(), cuda(), ensemble()
        reset_counts()
        calls.update(image_client=0, softmax=0)
        check(wire().as_numpy("fc6_1").reshape(-1), want, "wire")
        check_top(top_entries(wire(3), "fc6_1"), want, "wire")
        result["wire_p50_ms"] = p50_ms(wire, iters)
        logits, probs = cuda()
        if not (logits.is_cuda and probs.is_cuda):
            raise AssertionError("densenet_onnx's cuda shm output or its softmax left the card")
        check(logits.reshape(-1).cpu().numpy(), want, "cuda_shm")
        total = probs.sum().item()
        result["probabilities_sum"] = total
        result["probabilities_top1"] = int(probs.argmax().item())
        if abs(total - 1.0) > 1e-5 or result["probabilities_top1"] != int(want.argmax()):
            raise AssertionError(f"softmax of the served logits: sum {total}, top-1 "
                                 f"{result['probabilities_top1']}")
        result["cuda_shm_p50_ms"] = p50_ms(cuda, iters)
        for region in (cu_in, cu_out):
            if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
        image_client_counts = read_counts()
        image_client_calls = dict(calls)

        reset_counts()
        calls.update(ensemble=0)
        check(ensemble().as_numpy("CLASSIFICATION").reshape(-1), want_ens, "ensemble")
        check_top(top_entries(ensemble(3), "CLASSIFICATION"), want_ens, "ensemble")
        result["ensemble_p50_ms"] = p50_ms(ensemble, iters)
        ensemble_counts = read_counts()
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(cu_in)
        cudashm.destroy_shared_memory_region(cu_out)
        client.close()
        server.stop()

    expected = {
        "image_client": (image_client_counts, {
            "normalize_image": image_client_calls["image_client"],
            "softmax_probabilities": image_client_calls["softmax"]}),
        "ensemble_image": (ensemble_counts, {"normalize_image": calls["ensemble"]}),
    }
    for path, (counts, wanted) in expected.items():
        if counts != {name: wanted.get(name, 0) for name in COUNTERS}:
            raise AssertionError(f"launches on the {path} path: {counts}, expected {wanted}")
    result["launch_counts"] = {path: counts for path, (counts, _) in expected.items()}
    result["requests"] = {"image_client": image_client_calls["image_client"],
                          "ensemble_image": calls["ensemble"],
                          "softmax_calls": image_client_calls["softmax"]}
    result["profile"] = profile_densenet(densenet, 5)
    launches = {
        "normalize_image": (image_client_counts["normalize_image"]
                            + ensemble_counts["normalize_image"]),
        "softmax_probabilities": image_client_counts["softmax_probabilities"],
    }
    return result, launches


def drive_decoder(run, prompt, steps):
    """decoder_lm: the prompt as the sequence start, then ``steps`` greedy
    continuations; ``run(tokens, start, end)`` -> (logits, next_token)."""
    logits, tok = run(prompt, True, False)
    tokens, all_logits = [tok], [logits]
    for i in range(steps):
        logits, tok = run([tok], False, i == steps - 1)
        tokens.append(tok)
        all_logits.append(logits)
    return tokens, np.concatenate(all_logits)


# decoder_lm_batched over HTTP: one sequence a client and thread, prompts of
# lengths 1-8 drawn from seed 7, then BATCH_STEPS greedy continuations each
BATCH_SEQS = 8
BATCH_STEPS = 8
# the decode_attention row at the batched step's shape (B = slots): mixed
# positions with 0, 127 (a full cache, which the step clips to MAX_LEN - 1)
# and an idle slot (never started: pos 0, its output unused)
BATCHED_SHAPE = (8, 4, 128, 32)
BATCHED_POS = [0, 127, 5, 64, 31, 100, 77, 0]
# prefill rows and the disagg prompt
PREFILL_ROWS = 4
PREFILL_LEN = 6


def batch_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, size=n).tolist() for n in range(1, BATCH_SEQS + 1)]


def gate_first_window(model, size):
    """Hold the batched model's worker before its first window until
    ``size`` requests are queued, so that window holds them all; later
    windows coalesce on their own. Set before the model's first request
    (the worker starts with it); past 60 s the worker goes on and the
    width check fails instead."""
    real = model._collect

    def gated():
        deadline = time.monotonic() + 60
        while model._queue.qsize() < size and time.monotonic() < deadline:
            time.sleep(0.0005)
        model._collect = real
        return real()

    model._collect = gated


def drive_batched(url, prompts, steps):
    """Each prompt's sequence through decoder_lm_batched on a thread and
    client of its own, started together: (tokens, logits) per sequence."""
    results, errors = {}, []
    barrier = threading.Barrier(len(prompts))

    def run(i, prompt):
        client = httpclient.InferenceServerClient(url, network_timeout=600.0)
        try:
            def served(tokens, start, end):
                inp = httpclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
                inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
                r = client.infer("decoder_lm_batched", [inp], sequence_id=300 + i,
                                 sequence_start=start, sequence_end=end)
                return r.as_numpy("LOGITS"), int(r.as_numpy("NEXT_TOKEN")[0, 0])

            barrier.wait(60)
            results[i] = drive_decoder(served, prompt, steps)
        except Exception as e:  # raised below, after every thread ended
            errors.append((i, repr(e)))
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"decoder_lm_batched sequences failed: {errors}")
    return [results[i] for i in range(len(prompts))]


def in_process(model, seq_id):
    """``run(tokens, start, end)`` for drive_decoder, through ``model.execute``."""
    def run(tokens, start, end):
        out = model.execute({"TOKENS": np.array([tokens], dtype=np.int32)},
                            {"sequence_id": seq_id, "sequence_start": start, "sequence_end": end})
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])
    return run


def top2_margins(logits):
    top = np.sort(logits, axis=-1)
    return (top[:, -1] - top[:, -2]).tolist()


def full_slot_ride_along(batched, decoder):
    """In process on the card: a sequence fills its cache to MAX_LEN and
    stays live (no sequence_end) while another decodes beside it at
    pos == MAX_LEN: no error, the other's tokens as decoder_lm's, the full
    slot's cache untouched; the full sequence's next token is refused with
    max_len and frees its slot."""
    full = np.random.default_rng(11).integers(0, 256, size=decoder.MAX_LEN).tolist()
    in_process(batched, 900)(full, True, False)
    slot = batched._slot_of[900]
    if int(batched._pos[slot]) != decoder.MAX_LEN:
        raise AssertionError(f"the full sequence sits at {batched._pos[slot]}, not MAX_LEN")
    before = [kv[:, slot].clone() for kv in batched._caches]
    tokens, logits = drive_decoder(in_process(batched, 901), [5, 6, 7], 6)
    ref_tokens, ref_logits = drive_decoder(in_process(decoder, 902), [5, 6, 7], 6)
    untouched = all(torch.equal(kv[:, slot], old) for kv, old in zip(batched._caches, before))
    try:
        in_process(batched, 900)([1], False, False)
        refused = None
    except ValueError as e:
        refused = str(e)
    row = {"tokens": tokens, "decoder_lm_tokens": ref_tokens,
           "max_abs_logit_diff": float(np.abs(logits - ref_logits).max()),
           "cache_untouched": untouched, "overflow_error": refused,
           "live_after": batched.live_sequences()}
    if (tokens != ref_tokens or not untouched or refused is None or "max_len" not in refused
            or row["live_after"] != 0):
        raise AssertionError(f"the full-slot ride-along failed: {row}; decoder_lm top-2 "
                             f"margins {top2_margins(ref_logits)}")
    return row


def prompt_kv(decoder, prompt):
    """The decoder's cache after ``prompt`` as the disagg KV, [L*2, H, M, Dh] fp32."""
    caches = decoder.fresh_cache()
    decoder.prefill(caches, np.array(prompt), 0)
    return torch.stack([c[half] for c in caches for half in ("k", "v")]).float()


def disagg_handoff(client, core, decoder, prompt, max_tokens, kv_ref):
    """decoder_lm_disagg_prefill writes its KV into a colocated cuda shm
    output region over HTTP; decoder_lm_kv_decode streams from that region
    through ServerCore.infer_stream in process. ``kv_ref``: the KV the
    prompt must give (``prompt_kv``)."""
    shape = [decoder.LAYERS * 2, decoder.HEADS, decoder.MAX_LEN,
             decoder.D_MODEL // decoder.HEADS]
    nbytes = int(np.prod(shape)) * 4
    name = f"kv{os.urandom(4).hex()}"
    region = cudashm.create_shared_memory_region(name, nbytes, colocated=True)
    try:
        client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, nbytes)
        inp = httpclient.InferInput("TOKENS", [1, len(prompt)], "INT32")
        inp.set_data_from_numpy(np.array([prompt], dtype=np.int32))
        kv_out = httpclient.InferRequestedOutput("KV")
        kv_out.set_shared_memory(name, nbytes)
        r = client.infer("decoder_lm_disagg_prefill", [inp], outputs=[
            kv_out, httpclient.InferRequestedOutput("NEXT_TOKEN"),
            httpclient.InferRequestedOutput("POS")])
        first, pos = int(r.as_numpy("NEXT_TOKEN")[0, 0]), int(r.as_numpy("POS")[0, 0])
        kv = cudashm.get_contents_as_torch(region, "FP32", shape)
        on_device = kv.is_cuda
        request = {"inputs": [
            {"name": "KV", "datatype": "FP32", "shape": shape, "shm": (name, nbytes, 0)},
            {"name": "POS", "datatype": "INT32", "shape": [1],
             "array": np.array([pos], np.int32)},
            {"name": "FIRST_TOKEN", "datatype": "INT32", "shape": [1],
             "array": np.array([first], np.int32)},
            {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
             "array": np.array([max_tokens], np.int32)},
        ]}
        stream = [int(resp["outputs"][0]["array"][0, 0])
                  for resp in core.infer_stream("decoder_lm_kv_decode", "", request)]
        kv_exact = torch.equal(kv, kv_ref)
    finally:
        client.unregister_cuda_shared_memory()
        cudashm.destroy_shared_memory_region(region)
    return {"prompt": prompt, "stream": stream, "pos": pos, "kv_on_device": on_device,
            "kv_equals_the_cache": kv_exact, "kv_bytes": nbytes}


def time_batched_rounds(batched, widths, windows):
    """In process on the card, through the model's own window runner: for
    each width S, S sequences started with one token, then ``windows``
    windows of one token each (one round, its logits read back in one copy):
    wall per round, tokens per second, and at the widest, the device time
    per round and decode_attention launches per round (profiler)."""
    rows = []
    for width in widths:
        seqs = [950 + i for i in range(width)]

        def window(start, end):
            reqs = [_SeqRequest(s, [(s * 31 + 7) % 256], start, end) for s in seqs]
            batched._run_window(reqs)
            for req in reqs:
                req.future.result(timeout=60)

        window(True, False)
        window(False, False)  # warm
        t0 = time.perf_counter()
        for _ in range(windows):
            window(False, False)
        wall_ms = (time.perf_counter() - t0) * 1e3 / windows
        row = {"width": width, "windows": windows, "wall_ms_per_round": wall_ms,
               "tokens_per_s": width * 1e3 / wall_ms}
        if width == max(widths):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(windows):
                    window(False, False)
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            device_ms = sum(k["total_ms"] for k in kernels) / windows
            attention = [k for k in kernels if "decode_attention" in k["name"]]
            row.update({
                "device_ms_per_round": device_ms if kernels else None,
                "device_idle_share": 1 - device_ms / wall_ms if kernels else None,
                "decode_attention_launches_per_round": (
                    sum(k["count"] for k in attention) / windows if kernels else None),
                "decode_attention_ms_per_round": (
                    sum(k["total_ms"] for k in attention) / windows if kernels else None),
                "kernel_launches_per_round": (sum(k["count"] for k in kernels) / windows
                                              if kernels else None),
                "top_kernels": kernels[:8],
            })
        window(False, True)
        rows.append(row)
    if batched.live_sequences():
        raise AssertionError("the timed sequences did not end")
    return rows


def serve_and_check():
    prompt, steps, max_tokens = [1, 2, 3, 4], 8, 8
    result = {}
    encoder = LongContextEncoderModel(device="cuda")
    server = HttpInferenceServer(ServerCore(default_model_zoo("cuda") + [encoder])).start()
    client = httpclient.InferenceServerClient(server.url, network_timeout=600.0)
    try:
        decoder = server.core.model("decoder_lm")
        layers = decoder.LAYERS
        # one request first, so library set-up (cuBLAS) is not in the timings
        warm = httpclient.InferInput("TOKENS", [1, 1], "INT32")
        warm.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        client.infer("decoder_lm", [warm], sequence_id=16, sequence_start=True,
                     sequence_end=True)
        reset_counts()

        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        inputs = [httpclient.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
                  for n in ("INPUT0", "INPUT1")]
        res = client.infer("simple", inputs)
        if not (np.array_equal(res.as_numpy("OUTPUT0"), 2 * a)
                and not res.as_numpy("OUTPUT1").any()):
            raise AssertionError("simple returned wrong sums")

        result["identity"] = [
            drive_identity(client, 4 * MIB, 20),
            drive_identity(client, 64 * MIB, 5),
        ]

        def served(tokens, start, end):
            inp = httpclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
            inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
            r = client.infer("decoder_lm", [inp], sequence_id=17,
                             sequence_start=start, sequence_end=end)
            return r.as_numpy("LOGITS"), int(r.as_numpy("NEXT_TOKEN")[0, 0])

        before = client.client_infer_stat()
        t0 = time.perf_counter()
        gpu_tokens, gpu_logits = drive_decoder(served, prompt, steps)
        decoder_s = time.perf_counter() - t0
        after = client.client_infer_stat()
        t0 = time.perf_counter()
        events = list(client.generate_stream(
            "tiny_lm_generate", {"TOKENS": prompt, "MAX_TOKENS": max_tokens}))
        generate_s = time.perf_counter() - t0
        decoder_counts = read_counts()
        launches = decoder_counts["decode_attention"]

        # long_context_encoder: one request first (cuBLAS set-up, the kernel
        # library loaded) outside the counts; the CPU run gets the same weights
        warm = httpclient.InferInput("sequence", [8, encoder.encoder.dim], "FP32")
        warm.set_data_from_numpy(np.zeros((8, encoder.encoder.dim), np.float32))
        client.infer("long_context_encoder", [warm])
        cpu_encoder = LongContextEncoderModel(device="cpu")
        load_jax_params(cpu_encoder, {name: getattr(encoder.encoder, name).cpu().numpy()
                                      for name in WEIGHTS})
        reset_counts()
        result["long_context"], lc_requests = drive_long_context(
            client, cpu_encoder, (100, 4096, 8192), 10)
        lc_counts = read_counts()

        reset_counts()
        result["int8"], round_trips = drive_int8(client, 20)
        int8_counts = read_counts()

        # decoder_lm_batched: 8 sequences over HTTP, the first window holding
        # all 8 starts
        batched = server.core.model("decoder_lm_batched")
        gate_first_window(batched, BATCH_SEQS)
        prompts = batch_prompts()
        reset_counts()
        t0 = time.perf_counter()
        batched_runs = drive_batched(server.url, prompts, BATCH_STEPS)
        batched_s = time.perf_counter() - t0
        batched_counts = read_counts()
        batched_rounds = sum(batched.batch_histogram.values())
        histogram = dict(sorted(batched.batch_histogram.items()))

        reset_counts()
        result["full_slot"] = full_slot_ride_along(batched, decoder)
        full_slot_counts = read_counts()
        full_slot_rounds = sum(batched.batch_histogram.values()) - batched_rounds
        # (the ride-along's decoder_lm reference steps count too)
        full_slot_stepped = 3 + 6

        rows = np.random.default_rng(12).integers(
            0, decoder.VOCAB, size=(PREFILL_ROWS, PREFILL_LEN)).astype(np.int32)
        reset_counts()
        inp = httpclient.InferInput("TOKENS", list(rows.shape), "INT32").set_data_from_numpy(rows)
        prefill = client.infer("decoder_lm_prefill", [inp])
        prefill_counts = read_counts()
        prefill_logits = prefill.as_numpy("LOGITS")

        kv_ref = prompt_kv(decoder, prompt)
        reset_counts()
        result["disagg"] = disagg_handoff(client, server.core, decoder, prompt, max_tokens,
                                          kv_ref)
        disagg_counts = read_counts()

        # references, after the counts were read: decoder_lm on the card for
        # each prefill row and each batched sequence, and the disagg stream's
        # tiny_lm_generate
        prefill_rows = []
        for b, row in enumerate(rows.tolist()):
            inp = httpclient.InferInput("TOKENS", [1, PREFILL_LEN], "INT32")
            inp.set_data_from_numpy(np.array([row], dtype=np.int32))
            r = client.infer("decoder_lm", [inp], sequence_id=400 + b, sequence_start=True,
                             sequence_end=True)
            prefill_rows.append(r.as_numpy("LOGITS")[0])
        card_runs = [drive_decoder(in_process(decoder, 500 + i), p, BATCH_STEPS)
                     for i, p in enumerate(prompts)]
        disagg_want = [e["NEXT_TOKEN"] for e in client.generate_stream(
            "tiny_lm_generate", {"TOKENS": prompt, "MAX_TOKENS": max_tokens})]
        result["batched_timing"] = time_batched_rounds(batched, (1, 2, 4, 8), 50)
    finally:
        client.close()
        server.stop()

    gen_tokens = [e["NEXT_TOKEN"] for e in events]
    if [e["INDEX"] for e in events] != list(range(max_tokens)):
        raise AssertionError(f"generate_stream indices out of order: {events}")
    # tokens through the decode step: prompt + continuations, and for the
    # stream the prompt + every emitted token but the last
    stepped = (len(prompt) + steps) + (len(prompt) + max_tokens - 1)
    # each path launched its own kernels, once per token x layer, request or
    # round trip, and no other kernel
    # the disagg path: the prompt, then one step per streamed token but the last
    disagg_stepped = len(prompt) + len(result["disagg"]["stream"]) - 1
    expected = {
        "decoder": (decoder_counts, {"decode_attention": stepped * layers}),
        "long_context_encoder": (lc_counts, {"flash_attention": lc_requests}),
        "int8 wire": (int8_counts, {"quantize_int8": round_trips, "dequantize_int8": round_trips}),
        # one launch a layer a round, at B = slots
        "decoder_lm_batched": (batched_counts, {"decode_attention": batched_rounds * layers}),
        "full slot ride-along": (full_slot_counts, {"decode_attention": (
            full_slot_rounds + full_slot_stepped) * layers}),
        "decoder_lm_prefill": (prefill_counts, {"decode_attention": rows.size * layers}),
        "disagg": (disagg_counts, {"decode_attention": disagg_stepped * layers}),
    }
    for path, (counts, want) in expected.items():
        if counts != {name: want.get(name, 0) for name in COUNTERS}:
            raise AssertionError(f"launches on the {path} path: {counts}, expected {want}")
    result["launch_counts"] = {path: counts for path, (counts, _) in expected.items()}

    # the same weights on the CPU, through the plain attention version
    cpu = TinyDecoderModel(device="cpu")

    def on_cpu(tokens, start, end):
        out = cpu.execute({"TOKENS": np.array([tokens], dtype=np.int32)},
                          {"sequence_id": 17, "sequence_start": start, "sequence_end": end})
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])

    cpu_tokens, cpu_logits = drive_decoder(on_cpu, prompt, steps)
    cpu_gen = [int(r["NEXT_TOKEN"][0, 0]) for r in TinyGenerateModel(decoder=cpu).execute_decoupled(
        {"TOKENS": np.array([prompt], dtype=np.int32),
         "MAX_TOKENS": np.array([max_tokens], dtype=np.int32)}, {})]
    logit_err = float(np.abs(gpu_logits - cpu_logits).max())
    result["decoder"] = {
        "prompt": prompt, "gpu_tokens": gpu_tokens, "cpu_tokens": cpu_tokens,
        "max_abs_logit_diff": logit_err, "seconds": decoder_s,
        "generate_tokens": gen_tokens, "cpu_generate_tokens": cpu_gen,
        "generate_seconds": generate_s, "launches": launches,
        # client timers over the decoder_lm requests: send = request out to
        # response headers (server time included), receive = body read
        "client_request_ms": {
            kind: (after[f"cumulative_{kind}_time_ns"] - before[f"cumulative_{kind}_time_ns"])
            / 1e6 / (steps + 1)
            for kind in ("total_request", "send", "receive")},
        "tokens_stepped": stepped, "layers": layers,
    }
    if gpu_tokens != cpu_tokens or gen_tokens != cpu_gen:
        sorted_logits = np.sort(cpu_logits, axis=-1)
        raise AssertionError(
            f"greedy tokens differ from the CPU run: {result['decoder']}; CPU top-2 "
            f"margins {(sorted_logits[:, -1] - sorted_logits[:, -2]).tolist()}")
    if not np.isfinite(gpu_logits).all() or logit_err > 5e-2:
        raise AssertionError(f"logits differ from the CPU run by {logit_err}")

    # decoder_lm_batched: every sequence's tokens as decoder_lm's on the card
    # and as the CPU run's, logits within 5e-2 of the CPU run
    cpu_runs = [drive_decoder(in_process(cpu, 600 + i), p, BATCH_STEPS)
                for i, p in enumerate(prompts)]
    batched_err = max(float(np.abs(got[1] - ref[1]).max())
                      for got, ref in zip(batched_runs, cpu_runs))
    result["batched"] = {
        "prompts": prompts, "steps": BATCH_STEPS, "seconds": batched_s,
        "tokens": [run[0] for run in batched_runs],
        "card_decoder_lm_tokens": [run[0] for run in card_runs],
        "cpu_tokens": [run[0] for run in cpu_runs],
        "max_abs_logit_diff_vs_cpu": batched_err,
        "max_abs_logit_diff_vs_card_decoder_lm": max(
            float(np.abs(got[1] - ref[1]).max()) for got, ref in zip(batched_runs, card_runs)),
        "histogram": histogram, "rounds": batched_rounds,
        "launches": batched_counts["decode_attention"], "layers": layers,
    }
    for i, (got, card, ref) in enumerate(zip(batched_runs, card_runs, cpu_runs)):
        if got[0] != card[0] or got[0] != ref[0]:
            raise AssertionError(
                f"decoder_lm_batched sequence {i} tokens {got[0]}, decoder_lm on the card "
                f"{card[0]}, CPU {ref[0]}; top-2 margins batched {top2_margins(got[1])}, "
                f"card {top2_margins(card[1])}, CPU {top2_margins(ref[1])}")
    if not np.isfinite(np.concatenate([run[1] for run in batched_runs])).all() \
            or batched_err > 5e-2:
        raise AssertionError(f"decoder_lm_batched logits differ from the CPU run by {batched_err}")
    if max(histogram) < 4:
        raise AssertionError(f"no batched round of width >= 4: {histogram}")
    prefill_exact = all(prefill_logits[b].tobytes() == prefill_rows[b].tobytes()
                        for b in range(PREFILL_ROWS))
    result["prefill"] = {"rows": rows.tolist(), "bit_equal_to_decoder_lm": prefill_exact,
                         "next_tokens": prefill.as_numpy("NEXT_TOKEN")[:, 0].tolist()}
    if not prefill_exact:
        raise AssertionError("decoder_lm_prefill rows differ from decoder_lm on the card")
    disagg = result["disagg"]
    disagg["tiny_lm_generate"] = disagg_want
    if not (disagg["stream"] == disagg_want and disagg["kv_on_device"]
            and disagg["kv_equals_the_cache"]):
        raise AssertionError(f"the disagg handoff differs from tiny_lm_generate: {disagg}")

    # after the launch counts were read: where a served request's time goes
    result["profile"] = profile_decode(decoder, prompt, steps)
    result["long_context_profile"] = profile_long_context(encoder, 8192, 5)
    result["launches_by_path"] = {
        "decoder": launches, "decoder_lm_batched": batched_counts["decode_attention"],
        "full slot ride-along": full_slot_counts["decode_attention"],
        "decoder_lm_prefill": prefill_counts["decode_attention"],
        "disagg": disagg_counts["decode_attention"]}
    return result, {"decode_attention": launches, "flash_attention": lc_counts["flash_attention"],
                    "quantize_int8": int8_counts["quantize_int8"],
                    "dequantize_int8": int8_counts["dequantize_int8"]}


# ---------------------------------------------------------------------------
# phase 5: the served path over GRPC
# ---------------------------------------------------------------------------


def stream_decode(client, model, seq_id, prompt, steps):
    """decoder_lm-style greedy decode over the client's bidi stream, the way
    examples/grpc_decoder_stream_client.py drives it: (tokens, logits)."""
    responses = queue.Queue()
    client.start_stream(lambda r, e: responses.put((r, e)))
    try:
        def run(tokens, start, end):
            inp = grpcclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
            inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
            client.async_stream_infer(model, [inp], sequence_id=seq_id,
                                      sequence_start=start, sequence_end=end)
            result, error = responses.get(timeout=600)
            if error is not None:
                raise error
            return result.as_numpy("LOGITS"), int(result.as_numpy("NEXT_TOKEN")[0, 0])

        return drive_decoder(run, prompt, steps)
    finally:
        client.stop_stream()


def stream_batched(url, prompts, steps):
    """Each prompt's sequence through decoder_lm_batched on a GRPC stream,
    client and thread of its own, started together: (tokens, logits) each."""
    results, errors = {}, []
    barrier = threading.Barrier(len(prompts))

    def run(i, prompt):
        try:
            with grpcclient.InferenceServerClient(url) as client:
                barrier.wait(60)
                results[i] = stream_decode(client, "decoder_lm_batched", 300 + i, prompt, steps)
        except Exception as e:  # raised below, after every thread ended
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"decoder_lm_batched GRPC streams failed: {errors}")
    return [results[i] for i in range(len(prompts))]


def aio_identity(cuda_regions, mod, infer, x, shape, nbytes, n):
    """``n`` identity_fp32 requests through colocated cuda shm regions sent
    at once with asyncio.gather; the tensors the model handed back."""
    async def one(i):
        cin, cout, names = cuda_regions[i]
        cudashm.set_shared_memory_region_from_torch(cin, x * (i + 1))
        inp = mod.InferInput("INPUT0", shape, "FP32").set_shared_memory(names[0], nbytes)
        out = mod.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(names[1], nbytes)
        await infer("identity_fp32", [inp], outputs=[out])
        return cudashm.get_contents_as_torch(cout, "FP32", shape)

    async def run():
        return await asyncio.gather(*[one(i) for i in range(n)])
    return run()


def drive_aio(http_url, grpc_url, requests):
    """The aio clients: grpc.aio and http.aio each send ``requests`` simple
    and identity_fp32 (colocated cuda shm) requests through asyncio.gather;
    every output as expected and the two clients' outputs equal."""
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    n = 1 << 20
    shape, nbytes = [1, n], 4 * n
    x = torch.arange(n, dtype=torch.float32, device="cuda").reshape(shape) * 0.25
    tag = os.urandom(4).hex()
    regions = []
    for i in range(requests):
        names = (f"acin{i}{tag}", f"acout{i}{tag}")
        regions.append((cudashm.create_shared_memory_region(names[0], nbytes, colocated=True),
                        cudashm.create_shared_memory_region(names[1], nbytes, colocated=True),
                        names))

    async def session(mod, url):
        async with mod.InferenceServerClient(url) as client:
            for cin, cout, names in regions:
                for region, name in ((cin, names[0]), (cout, names[1])):
                    await client.register_cuda_shared_memory(
                        name, cudashm.get_raw_handle(region), 0, nbytes)
            simple = [mod.InferInput(name, [1, 16], "INT32").set_data_from_numpy(a)
                      for name in ("INPUT0", "INPUT1")]
            sums = await asyncio.gather(*[client.infer("simple", simple)
                                          for _ in range(requests)])
            ys = await aio_identity(regions, mod, client.infer, x, shape, nbytes, requests)
            await client.unregister_cuda_shared_memory()
            return [r.as_numpy("OUTPUT0") for r in sums], ys

    out = {}
    try:
        for name, mod, url in (("grpc_aio", grpc_aio, grpc_url), ("http_aio", http_aio, http_url)):
            t0 = time.perf_counter()
            sums, ys = asyncio.run(session(mod, url))
            seconds = time.perf_counter() - t0
            if not all(np.array_equal(s, 2 * a) for s in sums):
                raise AssertionError(f"{name}: simple returned wrong sums")
            for i, y in enumerate(ys):
                if not (y.is_cuda and torch.equal(y, x * (i + 1))):
                    raise AssertionError(f"{name}: identity_fp32 over cuda shm changed "
                                         f"request {i}'s tensor")
            out[name] = {"requests": 2 * requests, "seconds": seconds,
                         "sums": [s.tolist() for s in sums],
                         "identity_sums": [float(y.sum().item()) for y in ys]}
        if (out["grpc_aio"]["sums"] != out["http_aio"]["sums"]
                or out["grpc_aio"]["identity_sums"] != out["http_aio"]["identity_sums"]):
            raise AssertionError(f"the aio clients' outputs differ: {out}")
        for cin, cout, _ in regions:
            for region in (cin, cout):
                if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                    raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
    finally:
        for cin, cout, _ in regions:
            cudashm.destroy_shared_memory_region(cin)
            cudashm.destroy_shared_memory_region(cout)
    return out


def grpc_image_client(url, want, iters):
    """The image_client flow over GRPC: the noise image to the card,
    ``ops.normalize_image`` (INCEPTION), CHW into a colocated cuda shm
    region, ``densenet_onnx`` with its logits in another, then
    ``ops.softmax_probabilities`` on them. Checked against the CPU run's
    logits (top-1 equal, within 5e-2). Returns (row, requests, softmax
    calls)."""
    img = np.random.default_rng(0).uniform(0, 255, (224, 224, 3)).astype(np.float32)
    scale, shift = INCEPTION
    in_bytes, out_bytes = 3 * 224 * 224 * 4, VISION_CLASSES * 4
    tag = os.urandom(4).hex()
    names = (f"gdnin{tag}", f"gdnout{tag}")
    cu_in = cudashm.create_shared_memory_region(names[0], in_bytes, colocated=True)
    cu_out = cudashm.create_shared_memory_region(names[1], out_bytes, colocated=True)
    calls = {"requests": 0, "softmax": 0}
    client = grpcclient.InferenceServerClient(url)
    row = {}
    try:
        client.register_cuda_shared_memory(names[0], cudashm.get_raw_handle(cu_in), 0, in_bytes)
        client.register_cuda_shared_memory(names[1], cudashm.get_raw_handle(cu_out), 0,
                                           out_bytes)

        def run():
            calls["requests"] += 1
            x = torch.from_numpy(img).to("cuda")
            data_0 = ops.normalize_image(x, scale, shift, torch.float32).permute(2, 0, 1)
            cudashm.set_shared_memory_region_from_torch(cu_in, data_0.contiguous())
            inp = grpcclient.InferInput("data_0", [3, 224, 224], "FP32").set_shared_memory(
                names[0], in_bytes)
            out = grpcclient.InferRequestedOutput("fc6_1")
            out.set_shared_memory(names[1], out_bytes)
            client.infer("densenet_onnx", [inp], outputs=[out])
            logits = cudashm.get_contents_as_torch(cu_out, "FP32", [VISION_CLASSES, 1, 1])
            calls["softmax"] += 1
            probs = ops.softmax_probabilities(logits.reshape(1, VISION_CLASSES))
            torch.cuda.synchronize()  # the probabilities are ready to use
            return logits, probs

        logits, probs = run()
        if not (logits.is_cuda and probs.is_cuda):
            raise AssertionError("densenet_onnx's GRPC cuda shm output or its softmax left "
                                 "the card")
        got = logits.reshape(-1).cpu().numpy()
        diff = float(np.abs(got - want).max())
        row["max_abs_logit_diff_vs_cpu"] = diff
        row["top1"], row["cpu_top1"] = int(got.argmax()), int(want.argmax())
        row["probabilities_sum"] = probs.sum().item()
        row["probabilities_top1"] = int(probs.argmax().item())
        if (not np.isfinite(got).all() or diff > 5e-2 or row["top1"] != row["cpu_top1"]
                or row["probabilities_top1"] != row["cpu_top1"]
                or abs(row["probabilities_sum"] - 1.0) > 1e-5):
            raise AssertionError(f"image_client over GRPC differs from the CPU run: {row}")
        row["cuda_shm_p50_ms"] = p50_ms(run, iters)
        for region in (cu_in, cu_out):
            if np.frombuffer(region.host_buffer(), dtype=np.uint8).any():
                raise AssertionError(f"cuda shm region {region.name} was mirrored to the host")
    finally:
        client.unregister_cuda_shared_memory()
        client.close()
        cudashm.destroy_shared_memory_region(cu_in)
        cudashm.destroy_shared_memory_region(cu_out)
    return row, calls["requests"], calls["softmax"]


def serve_grpc(served, vision):
    """The port's GRPC server over ``ServerCore(default_model_zoo("cuda"))``
    plus the vision models, driven by the port's GRPC clients (and http.aio
    through an HTTP frontend on the same core), each path with every launch
    count set to 0 just before it and read just after. ``served`` and
    ``vision`` are the HTTP phases' results, which the GRPC paths must
    reproduce."""
    prompt, steps = served["decoder"]["prompt"], 8
    core = ServerCore(default_model_zoo("cuda")
                      + build_image_ensemble(VISION_CLASSES, VISION_WIDTH, device="cuda"))
    server = GrpcInferenceServer(core, max_workers=2 * BATCH_SEQS).start()
    http_server = HttpInferenceServer(core).start()
    client = grpcclient.InferenceServerClient(server.url)
    result, counts, expected = {}, {}, {}
    try:
        # warm-up outside the counts: cuBLAS and cuDNN set-up, kernels loaded
        warm = grpcclient.InferInput("TOKENS", [1, 1], "INT32")
        warm.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        client.infer("decoder_lm", [warm], sequence_id=16, sequence_start=True,
                     sequence_end=True)
        grpc_image_client(server.url, np.asarray(vision["cpu_logits"], np.float32), 1)

        # 1. simple and the admin surface
        reset_counts()
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        inputs = [grpcclient.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
                  for n in ("INPUT0", "INPUT1")]
        sent = 5
        for _ in range(sent):
            res = client.infer("simple", inputs)
            if not (np.array_equal(res.as_numpy("OUTPUT0"), 2 * a)
                    and not res.as_numpy("OUTPUT1").any()):
                raise AssertionError("simple over GRPC returned wrong sums")
        meta = client.get_model_metadata("simple")
        config = client.get_model_config("decoder_lm")["config"]
        index = client.get_model_repository_index()
        client.unload_model("simple_string")
        unloaded = client.is_model_ready("simple_string")
        client.load_model("simple_string")
        stats = client.get_inference_statistics("simple")["model_stats"][0]
        admin = {
            "live": client.is_server_live(), "ready": client.is_server_ready(),
            "simple_ready": client.is_model_ready("simple"),
            "extensions": client.get_server_metadata()["extensions"],
            "simple_inputs": [i["name"] for i in meta["inputs"]],
            "decoder_lm_config_inputs": [i["name"] for i in config["input"]],
            "repository_models": len(index),
            "unloaded_then_ready": (unloaded, client.is_model_ready("simple_string")),
            "simple_success_count": stats["inference_stats"]["success"]["count"],
            "simple_sent": sent,
        }
        result["admin"] = admin
        if not (admin["live"] and admin["ready"] and admin["simple_ready"]
                and admin["unloaded_then_ready"] == (False, True)
                and admin["simple_success_count"] == sent
                and admin["repository_models"] == len(core.repository_index())):
            raise AssertionError(f"the GRPC admin surface: {admin}")
        counts["simple and admin"], expected["simple and admin"] = read_counts(), {}

        # 2. identity_fp32 by data plane
        reset_counts()
        result["identity"] = [drive_identity(client, 4 * MIB, 20, grpcclient),
                              drive_identity(client, 64 * MIB, 5, grpcclient)]
        counts["identity"], expected["identity"] = read_counts(), {}

        # 3. decoder_lm over one bidi stream
        decoder = core.model("decoder_lm")
        layers = decoder.LAYERS
        reset_counts()
        t0 = time.perf_counter()
        tokens, logits = stream_decode(client, "decoder_lm", 17, prompt, steps)
        seconds = time.perf_counter() - t0
        counts["decoder"] = read_counts()
        expected["decoder"] = {"decode_attention": (len(prompt) + steps) * layers}
        http_dec = served["decoder"]
        result["decoder"] = {"tokens": tokens, "http_tokens": http_dec["gpu_tokens"],
                             "cpu_tokens": http_dec["cpu_tokens"], "seconds": seconds,
                             "ms_per_token": seconds * 1e3 / (steps + 1),
                             "launches": counts["decoder"]["decode_attention"],
                             "tokens_stepped": len(prompt) + steps, "layers": layers}
        if tokens != http_dec["gpu_tokens"] or tokens != http_dec["cpu_tokens"]:
            raise AssertionError(f"decoder_lm over GRPC: {result['decoder']}")
        if not np.isfinite(logits).all():
            raise AssertionError("decoder_lm over GRPC gave non-finite logits")

        # 4. decoder_lm_batched over 8 concurrent streams
        batched = core.model("decoder_lm_batched")
        gate_first_window(batched, BATCH_SEQS)
        prompts = batch_prompts()
        reset_counts()
        t0 = time.perf_counter()
        runs = stream_batched(server.url, prompts, BATCH_STEPS)
        seconds = time.perf_counter() - t0
        counts["decoder_lm_batched"] = read_counts()
        rounds = sum(batched.batch_histogram.values())
        histogram = dict(sorted(batched.batch_histogram.items()))
        expected["decoder_lm_batched"] = {"decode_attention": rounds * layers}
        card = served["batched"]["card_decoder_lm_tokens"]
        result["batched"] = {"tokens": [r[0] for r in runs], "card_decoder_lm_tokens": card,
                             "seconds": seconds, "histogram": histogram, "rounds": rounds,
                             "launches": counts["decoder_lm_batched"]["decode_attention"],
                             "layers": layers}
        if [r[0] for r in runs] != card:
            raise AssertionError(f"decoder_lm_batched over GRPC: {result['batched']}")
        if max(histogram) < 4:
            raise AssertionError(f"no batched GRPC round of width >= 4: {histogram}")

        # 5. the image_client flow over GRPC, input and logits in cuda shm
        reset_counts()
        result["image_client"], requests, softmax_calls = grpc_image_client(
            server.url, np.asarray(vision["cpu_logits"], np.float32), 20)
        counts["image_client"] = read_counts()
        expected["image_client"] = {"normalize_image": requests,
                                    "softmax_probabilities": softmax_calls}
        result["image_client"].update(requests=requests, softmax_calls=softmax_calls)

        # 6. the aio clients
        reset_counts()
        result["aio"] = drive_aio(http_server.url, server.url, 4)
        counts["aio"], expected["aio"] = read_counts(), {}
    finally:
        client.close()
        server.stop()
        http_server.stop()
        core.model("decoder_lm_batched").unload()
    for path, want in expected.items():
        if counts[path] != {name: want.get(name, 0) for name in COUNTERS}:
            raise AssertionError(f"launches on the GRPC {path} path: {counts[path]}, "
                                 f"expected {want}")
    result["launch_counts"] = counts
    return result


# phase 6: resilience, telemetry, integrity and flight on the served paths.
# Seeded backoff; a GRPC channel that redials faster than the backoff (with a
# subchannel pool of its own, so one client's dead connection is not shared)
RESILIENCE_SEED = 0xC11E
FAST_REDIAL = [
    ("grpc.use_local_subchannel_pool", 1),
    ("grpc.initial_reconnect_backoff_ms", 50),
    ("grpc.min_reconnect_backoff_ms", 50),
    ("grpc.max_reconnect_backoff_ms", 100),
    ("grpc.max_send_message_length", 2**31 - 1),
    ("grpc.max_receive_message_length", 2**31 - 1),
]
# image_client requests per fault, the decoder step at which the fault
# lands, bytes into a connection before a reset (mid-body of the 588 KiB
# image request; past a decoder request, inside its ~1.5 KiB response)
FAULT_REQUESTS = 6
FAULT_STEP = 3
IMAGE_RESET_BYTES = 300_000
DECODER_RESET_BYTES = 1_200
# telemetry paths and the hooks' host cost: requests per path, interleaved
# rounds (bare, hooked, hooked, bare per round)
SPLIT_REQUESTS = 10
HOOK_ROUNDS = 3
HOOK_REQUESTS = 20


def resilience_policy(breaker=None):
    return ResiliencePolicy(retry=RetryPolicy(
        max_attempts=6, initial_backoff_s=0.05, max_backoff_s=0.4,
        rng=random.Random(RESILIENCE_SEED)), breaker=breaker)


def median(values):
    return statistics.median(values) if values else None


def split_of(tel, core):
    """Each traced request's client phases beside the server's queue and
    compute time, joined by trace id: p50s in ms."""
    traces = tel.recent_traces()
    access = {r["trace_id"]: r for r in core.access_records(1024)}
    phases, server = {}, {"queue": [], "compute": [], "total": []}
    for trace in traces:
        for ph in trace["phases"]:
            phases.setdefault(ph["name"], []).append(ph["duration_ms"])
        record = access.get(trace["trace_id"])
        if record is None or record["client_span_id"] != trace["span_id"]:
            raise AssertionError(f"span {trace['trace_id']} has no server access record")
        for key in server:
            server[key].append(record[f"{key}_ns"] / 1e6)
    return {"requests": len(traces),
            "client_ms_p50": {name: median(v) for name, v in phases.items()},
            "client_total_ms_p50": median([t["duration_ms"] for t in traces]),
            "server_queue_ms_p50": median(server["queue"]),
            "server_compute_ms_p50": median(server["compute"]),
            "server_total_ms_p50": median(server["total"])}


def serve_resilience(served, vision, device="cuda"):
    """Phase 6: the port's HTTP and GRPC servers over the default zoo and
    the vision models on ``device``, the port's ``ChaosProxy`` in front of
    each, every client with contract validation on, and a process-wide
    data-plane recorder. Each path runs with every launch count set to 0
    just before it and read just after; decode_attention launches are held
    to what the server ran (its execution count, each request's tokens,
    times the layers), as a retried request that reached the server runs
    the model again. ``served`` and ``vision`` are the HTTP phases' results
    (the decoder's prompt, CPU tokens and CPU logits).

    On a CPU ``device`` the wrappers run their plain versions and launch
    nothing; the script itself runs this phase only on the card."""
    on_card = torch.device(device).type == "cuda"
    prompt, steps = served["decoder"]["prompt"], 8
    cpu_tokens = served["decoder"]["cpu_tokens"]
    want = np.asarray(vision["cpu_logits"], np.float32)
    core = ServerCore(default_model_zoo(device)
                      + build_image_ensemble(VISION_CLASSES, VISION_WIDTH, device=device),
                      device=device)
    layers = core.model("decoder_lm").LAYERS
    http_server = HttpInferenceServer(core).start()
    # a bidi stream holds a handler thread for its life, and a reconnect
    # opens another before the dead one's handler notices
    grpc_server = GrpcInferenceServer(core, max_workers=2 * BATCH_SEQS + 8).start()
    http_proxy = ChaosProxy("127.0.0.1", http_server.port).start()
    grpc_proxy = ChaosProxy("127.0.0.1", grpc_server.port).start()
    previous_recorder = dataplane()
    recorder = enable_dataplane()
    integrity = IntegrityPolicy(stats=IntegrityStats())
    flight = FlightRecorder(baseline_ratio=0.0, rng=random.Random(RESILIENCE_SEED))
    fault_tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(1),
                          flight=flight)
    img = np.random.default_rng(0).uniform(0, 255, (224, 224, 3)).astype(np.float32)
    scale, shift = INCEPTION
    in_bytes, out_bytes = 3 * 224 * 224 * 4, VISION_CLASSES * 4
    result, counts, expected = {}, {}, {}
    seen_failures = []
    dp = {"created": 0, "destroyed": 0, "registered": 0, "resident": 0, "peak": 0,
          "requests": 0}
    clients = []

    def client(url, tel=None, policy=None, checked=True):
        c = httpclient.InferenceServerClient(url, network_timeout=600.0)
        clients.append(c)
        c.configure_integrity(integrity if checked else False)
        if tel is not None:
            c.configure_telemetry(tel)
        if policy is not None:
            c.configure_resilience(policy)
        return c

    def executions(model):
        return core.statistics(model)["model_stats"][0]["execution_count"]

    def decoder_gate(path, before, extra_tokens):
        """decode_attention launches = layers x the tokens the server ran:
        one a request, plus each executed start's prompt beyond one."""
        ran = executions("decoder_lm") - before
        expected[path] = {"decode_attention": layers * (ran + extra_tokens) if on_card else 0}
        return ran

    def regions(c, tag, sizes):
        """Colocated cuda regions, registered on ``c``, accounted for the
        data-plane check."""
        made = []
        for i, nbytes in enumerate(sizes):
            name = f"{tag}{i}{os.urandom(3).hex()}"
            region = cudashm.create_shared_memory_region(name, nbytes, colocated=True,
                                                         device=device)
            c.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, nbytes)
            made.append((name, region))
            dp["created"] += 1
            dp["registered"] += 1
            dp["resident"] += nbytes
            dp["peak"] = max(dp["peak"], dp["resident"])
        return made

    def release(c, made):
        for name, region in made:
            c.unregister_cuda_shared_memory(name)
            cudashm.destroy_shared_memory_region(region)
            dp["destroyed"] += 1
            dp["resident"] -= region.byte_size

    calls = {"normalize": 0, "softmax": 0}

    def data_0():
        calls["normalize"] += 1
        x = torch.from_numpy(img).to(device)
        return ops.normalize_image(x, scale, shift, torch.float32).permute(2, 0, 1).contiguous()

    def softmax(logits):
        calls["softmax"] += 1
        probs = ops.softmax_probabilities(logits.reshape(1, VISION_CLASSES))
        if on_card:
            torch.cuda.synchronize()  # the probabilities are ready to use
        return probs

    def image_wire(c):
        inp = httpclient.InferInput("data_0", [3, 224, 224], "FP32")
        inp.set_data_from_numpy(data_0().cpu().numpy())
        res = c.infer("densenet_onnx", [inp], outputs=[httpclient.InferRequestedOutput("fc6_1")])
        logits = res.as_torch("fc6_1", device=device)
        return logits, softmax(logits)

    def image_cuda(c, made):
        (in_name, cu_in), (out_name, cu_out) = made
        cudashm.set_shared_memory_region_from_torch(cu_in, data_0())
        inp = httpclient.InferInput("data_0", [3, 224, 224], "FP32").set_shared_memory(
            in_name, in_bytes)
        out = httpclient.InferRequestedOutput("fc6_1").set_shared_memory(out_name, out_bytes)
        c.infer("densenet_onnx", [inp], outputs=[out])
        dp["requests"] += 1
        logits = cudashm.get_contents_as_torch(cu_out, "FP32", [VISION_CLASSES, 1, 1])
        return logits, softmax(logits)

    def check_image(logits, probs, what):
        got = logits.reshape(-1).cpu().numpy()
        diff = float(np.abs(got - want).max())
        top1, ptop1 = int(got.argmax()), int(probs.argmax().item())
        if (not np.isfinite(got).all() or diff > 5e-2 or top1 != int(want.argmax())
                or ptop1 != top1 or abs(probs.sum().item() - 1.0) > 1e-5):
            raise AssertionError(f"{what}: top-1 {top1} (CPU {int(want.argmax())}), max "
                                 f"logit diff {diff}")
        return top1, diff

    x_id = torch.arange(MIB, dtype=torch.float32, device=device).reshape(1, MIB) * 0.5

    def identity_cuda(c, made):
        (in_name, cu_in), (out_name, cu_out) = made
        cudashm.set_shared_memory_region_from_torch(cu_in, x_id)
        inp = httpclient.InferInput("INPUT0", [1, MIB], "FP32").set_shared_memory(
            in_name, 4 * MIB)
        out = httpclient.InferRequestedOutput("OUTPUT0").set_shared_memory(out_name, 4 * MIB)
        c.infer("identity_fp32", [inp], outputs=[out])
        dp["requests"] += 1
        y = cudashm.get_contents_as_torch(cu_out, "FP32", [1, MIB])
        if not torch.equal(y, x_id):
            raise AssertionError("identity_fp32 over cuda shm changed the tensor")

    def decoder_step(c, seq, tokens, start, end=False):
        inp = httpclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
        inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
        res = c.infer("decoder_lm", [inp], sequence_id=seq, sequence_start=start,
                      sequence_end=end)
        return int(res.as_numpy("NEXT_TOKEN")[0, 0])

    def decode_sequence(c, seq):
        """prompt, then ``steps`` greedy continuations: (tokens, seconds)."""
        t0 = time.perf_counter()
        tokens = [decoder_step(c, seq, prompt, True)]
        for i in range(steps):
            tokens.append(decoder_step(c, seq, [tokens[-1]], False, i == steps - 1))
        return tokens, time.perf_counter() - t0

    try:
        direct = client(http_server.url)
        for model in ("simple", "identity_fp32", "decoder_lm", "densenet_onnx"):
            direct.get_model_metadata(model)  # primes the contract cache
        # warm-up outside the counts: cuBLAS and cuDNN set-up, kernels loaded
        check_image(*image_wire(direct), "warm-up")
        decode_sequence(direct, 50)

        # 1. the image_client flow (idempotent) under flap and reset@N, a
        #    connection a request so the faults land
        for name, fault in (("flap", Fault("flap", every=2)),
                            ("reset@N", Fault("reset", after_bytes=IMAGE_RESET_BYTES,
                                              every=2))):
            reset_counts()
            calls.update(normalize=0, softmax=0)
            before = executions("densenet_onnx")
            policy = fault_tel.attach(resilience_policy())
            faulted_before = http_proxy.stats["faulted"]
            http_proxy.fault = fault
            top1s, diffs = [], []
            for _ in range(FAULT_REQUESTS):
                top1, diff = check_image(*image_wire(client(http_proxy.url, fault_tel, policy)),
                                         f"image_client under {name}")
                top1s.append(top1)
                diffs.append(diff)
            http_proxy.heal()
            path = f"image_client under {name}"
            counts[path] = read_counts()
            expected[path] = {"normalize_image": calls["normalize"] if on_card else 0,
                              "softmax_probabilities": calls["softmax"] if on_card else 0}
            stats = policy.stats.as_dict()
            result[path] = {"requests": FAULT_REQUESTS, "errors": 0, "top1": top1s,
                            "cpu_top1": int(want.argmax()),
                            "max_abs_logit_diff_vs_cpu": max(diffs), "policy": stats,
                            "server_executions": executions("densenet_onnx") - before,
                            "faulted_connections": http_proxy.stats["faulted"] - faulted_before}
            if stats["retries"] < 1 or stats["calls"] != FAULT_REQUESTS:
                raise AssertionError(f"{path}: no retry under the fault: {stats}")

        # 2. a decoder_lm sequence under reset@N: its faulted request is not
        #    re-sent; the tokens before it are the CPU run's
        reset_counts()
        before = executions("decoder_lm")
        policy = fault_tel.attach(resilience_policy())
        c = client(http_proxy.url, fault_tel, policy)
        tokens = [decoder_step(c, 41, prompt, True)]
        for _ in range(FAULT_STEP - 1):
            tokens.append(decoder_step(c, 41, [tokens[-1]], False))
        sequence_stats = policy.stats.as_dict()
        http_proxy.fault = Fault("reset", after_bytes=DECODER_RESET_BYTES, limit=1)
        faulted = client(http_proxy.url, fault_tel, policy)  # a new connection: faulted
        try:
            decoder_step(faulted, 41, [tokens[-1]], False)
            raise AssertionError("the faulted decoder_lm request did not fail")
        except InferenceServerException as e:
            domain = classify_fault(e)
            seen_failures.append(("decoder_lm", domain))
        http_proxy.heal()
        after = policy.stats.as_dict()
        ran = decoder_gate("decoder_lm under reset@N", before, len(prompt) - 1)
        counts["decoder_lm under reset@N"] = read_counts()
        result["decoder_lm under reset@N"] = {
            "tokens_before_fault": tokens, "cpu_tokens": cpu_tokens[:FAULT_STEP],
            "fault_domain": domain, "requests_sent": FAULT_STEP + 1, "server_executions": ran,
            "faulted_call_attempts": after["attempts"] - sequence_stats["attempts"]}
        if (tokens != cpu_tokens[:FAULT_STEP] or after["calls"] - sequence_stats["calls"] != 1
                or after["attempts"] - sequence_stats["attempts"] != 1
                or ran > FAULT_STEP + 1 or ran < FAULT_STEP):
            raise AssertionError(f"decoder_lm under reset@N: {result['decoder_lm under reset@N']}")
        decoder_step(direct, 41, prompt, True, True)  # ends the broken sequence

        # 3. a GRPC bidi stream with auto_reconnect under a reset: one
        #    StreamReconnected naming the in-flight sequence request; the
        #    application re-drives the sequence from the tokens it has
        reset_counts()
        before = executions("decoder_lm")
        events = queue.Queue()
        gc = grpcclient.InferenceServerClient(grpc_proxy.url, channel_args=FAST_REDIAL)
        gc.configure_integrity(integrity)
        gc.configure_telemetry(fault_tel)
        gc.configure_resilience(fault_tel.attach(resilience_policy()))
        gc.start_stream(lambda r, e: events.put((r, e)), auto_reconnect=True)
        checkers = [StreamChecker(grpc_proxy.url, integrity)]
        reconnects = []
        starts = []

        def stream_step(seq, tokens, start, rid):
            inp = grpcclient.InferInput("TOKENS", [1, len(tokens)], "INT32")
            inp.set_data_from_numpy(np.array([tokens], dtype=np.int32))
            gc.async_stream_infer("decoder_lm", [inp], sequence_id=seq, sequence_start=start,
                                  request_id=rid)
            if start:
                starts.append(len(tokens))

        def stream_result(reconnect=False):
            """The next token, or (``reconnect``) the next StreamReconnected;
            each wire stream's responses pass a StreamChecker of their own
            (request ids count up from 0 on each)."""
            while True:
                res, err = events.get(timeout=60)
                if err is not None:
                    raise err
                if isinstance(res, StreamReconnected):
                    reconnects.append(res)
                    checkers.append(StreamChecker(grpc_proxy.url, integrity))
                    if reconnect:
                        return res
                    continue
                if reconnect:
                    raise AssertionError(f"a response where the reconnect was due: "
                                         f"{res.get_response()}")
                rid = res.get_response()["id"]
                checkers[-1].observe({"index": int(rid[1:])})
                return int(res.as_numpy("NEXT_TOKEN")[0, 0])

        try:
            stream_step(42, prompt, True, "t0")
            tokens = [stream_result()]
            for i in range(1, FAULT_STEP):
                stream_step(42, [tokens[-1]], False, f"t{i}")
                tokens.append(stream_result())
            grpc_proxy.pause_forwarding = True
            stream_step(42, [tokens[-1]], False, f"t{FAULT_STEP}")  # in flight
            time.sleep(0.2)
            grpc_proxy.reset_active()
            grpc_proxy.pause_forwarding = False
            # the reconnect first: a request enqueued while the dead stream
            # still looks alive would be abandoned with the in-flight one
            stream_result(reconnect=True)
            # re-driven: a new sequence over the prompt and the tokens so far
            stream_step(43, prompt + tokens, True, "r0")
            tokens.append(stream_result())
            for i in range(1, steps + 1 - FAULT_STEP):
                stream_step(43, [tokens[-1]], False, f"r{i}")
                tokens.append(stream_result())
        finally:
            gc.stop_stream()
            gc.close()
        ran = decoder_gate("grpc stream auto_reconnect", before,
                           sum(n - 1 for n in starts))
        counts["grpc stream auto_reconnect"] = read_counts()
        event = reconnects[0] if reconnects else None
        result["grpc stream auto_reconnect"] = {
            "tokens": tokens, "cpu_tokens": cpu_tokens, "reconnects": len(reconnects),
            "abandoned_request_ids": event.abandoned_request_ids if event else None,
            "resent_request_ids": event.resent_request_ids if event else None,
            "server_executions": ran, "stream_checker_events": [k.events for k in checkers]}
        if (len(reconnects) != 1 or event.abandoned_request_ids != [f"t{FAULT_STEP}"]
                or event.resent_request_ids or tokens != cpu_tokens
                or ran != FAULT_STEP + 1 + steps - FAULT_STEP):
            raise AssertionError(f"grpc stream auto_reconnect: "
                                 f"{result['grpc stream auto_reconnect']}")
        direct_grpc = grpcclient.InferenceServerClient(grpc_server.url)
        inp = grpcclient.InferInput("TOKENS", [1, 1], "INT32")
        inp.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        for seq in (42, 43):  # end both sequences
            direct_grpc.infer("decoder_lm", [inp], sequence_id=seq, sequence_start=True,
                              sequence_end=True)
        direct_grpc.close()

        # 4. a circuit breaker under blackhole: opens, fast-fails without a
        #    connection, and after the recovery window probes once
        reset_counts()
        transitions = []
        breaker = CircuitBreaker(failure_threshold=0.5, window=4, min_calls=4,
                                 recovery_time_s=0.5)
        policy = fault_tel.attach(ResiliencePolicy(retry=None, breaker=breaker))
        breaker.on_transition = lambda state: (transitions.append(state),
                                               fault_tel.on_breaker_transition(state))
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        simple_in = [httpclient.InferInput(n, [1, 16], "INT32").set_data_from_numpy(a)
                     for n in ("INPUT0", "INPUT1")]
        http_proxy.fault = Fault("blackhole")
        c = client(http_proxy.url, fault_tel, policy)
        for _ in range(4):
            try:
                c.infer("simple", simple_in, client_timeout=0.25)
                raise AssertionError("simple answered through a blackhole")
            except InferenceServerException as e:
                seen_failures.append(("simple", classify_fault(e)))
        state_after_faults = breaker.state
        connections = http_proxy.stats["connections"]
        try:
            c.infer("simple", simple_in, client_timeout=0.25)
            raise AssertionError("an open breaker let a request through")
        except CircuitOpenError:
            seen_failures.append(("simple", "fast_fail"))
        fast_fail_connections = http_proxy.stats["connections"] - connections
        http_proxy.heal()
        http_proxy.reset_active()
        time.sleep(0.55)
        probe = c.infer("simple", simple_in, client_timeout=30.0)
        counts["breaker"], expected["breaker"] = read_counts(), {}
        result["breaker"] = {"state_after_faults": state_after_faults,
                             "transitions": transitions, "policy": policy.stats.as_dict(),
                             "fast_fail_connections": fast_fail_connections,
                             "probe_ok": bool(np.array_equal(probe.as_numpy("OUTPUT0"), 2 * a))}
        if (state_after_faults != "open" or transitions != ["open", "half_open", "closed"]
                or fast_fail_connections != 0 or not result["breaker"]["probe_ok"]
                or policy.stats.as_dict()["fast_fails"] != 1):
            raise AssertionError(f"breaker under blackhole: {result['breaker']}")

        # the flight recorder kept each failure the caller saw, once
        flight_stats = flight.stats()
        retained = flight_stats["retained"]
        result["flight"] = {"failures_seen": len(seen_failures), "seen": seen_failures,
                            "retained": retained, "requests": flight_stats["requests"]}
        if retained["error"] + retained["shed"] != len(seen_failures):
            raise AssertionError(f"flight recorder: {result['flight']}")

        # 5. the round-trip split: client phases beside the server's queue and
        #    compute time, joined by trace id (telemetry at ratio 1.0)
        split = {}
        tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(2))
        c = client(http_server.url, tel)
        x_host = x_id.cpu().numpy()
        reset_counts()
        for _ in range(SPLIT_REQUESTS):
            inp = httpclient.InferInput("INPUT0", [1, MIB], "FP32").set_data_from_numpy(x_host)
            if not np.array_equal(c.infer("identity_fp32", [inp]).as_numpy("OUTPUT0"),
                                  x_host):
                raise AssertionError("identity_fp32 over the wire changed the tensor")
        split["identity_fp32 4 MiB wire"] = split_of(tel, core)
        counts["split identity"], expected["split identity"] = read_counts(), {}

        tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(3))
        c = client(http_server.url, tel)
        made = regions(c, "spid", (4 * MIB, 4 * MIB))
        for _ in range(SPLIT_REQUESTS):
            identity_cuda(c, made)
        release(c, made)
        split["identity_fp32 4 MiB cuda shm"] = split_of(tel, core)

        tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(4))
        c = client(http_server.url, tel)
        reset_counts()
        before = executions("decoder_lm")
        tokens, _ = decode_sequence(c, 44)
        decoder_gate("split decoder_lm", before, len(prompt) - 1)
        counts["split decoder_lm"] = read_counts()
        if tokens != cpu_tokens:
            raise AssertionError(f"decoder_lm with telemetry: {tokens} vs CPU {cpu_tokens}")
        split["decoder_lm per token"] = split_of(tel, core)

        tel = Telemetry(sample="ratio", sample_ratio=1.0, rng=random.Random(5))
        c = client(http_server.url, tel)
        made = regions(c, "spim", (in_bytes, out_bytes))
        reset_counts()
        calls.update(normalize=0, softmax=0)
        for _ in range(SPLIT_REQUESTS):
            check_image(*image_cuda(c, made), "image_client with telemetry")
        counts["split image_client"] = read_counts()
        expected["split image_client"] = {
            "normalize_image": calls["normalize"] if on_card else 0,
            "softmax_probabilities": calls["softmax"] if on_card else 0}
        split["image_client cuda shm"] = split_of(tel, core)
        # compute_ns is the host time of model.execute; the same request's
        # device time from the profiler beside it
        device_ms = None
        if on_card:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                image_cuda(c, made)
                torch.cuda.synchronize()
            kernels_ms = sum(k["total_ms"] for k in device_kernels(prof))
            device_ms = kernels_ms if kernels_ms > 0 else None
        last = tel.recent_traces()[-1]
        record = next(r for r in core.access_records(1024)
                      if r["trace_id"] == last["trace_id"])
        split["image_client cuda shm"]["profiled_request"] = {
            "server_compute_ms": record["compute_ns"] / 1e6,
            "server_total_ms": record["total_ns"] / 1e6,
            "device_ms": device_ms, "client_total_ms": last["duration_ms"]}
        release(c, made)
        result["split"] = split

        # 6. the hooks' host cost: the same paths with no hooks (no
        #    telemetry, resilience or integrity) and with all three, in
        #    interleaved rounds
        bare = client(http_server.url, checked=False)
        hooked = client(http_server.url, Telemetry(sample="ratio", sample_ratio=1.0,
                                                   rng=random.Random(6)),
                        resilience_policy())
        bare_regions = regions(bare, "hkb", (4 * MIB, 4 * MIB))
        hooked_regions = regions(hooked, "hkh", (4 * MIB, 4 * MIB))
        cost = {"bare": {"identity_p50_ms": [], "decoder_ms_per_token": []},
                "hooked": {"identity_p50_ms": [], "decoder_ms_per_token": []}}
        reset_counts()
        before = executions("decoder_lm")
        seq = 60
        for _ in range(HOOK_ROUNDS):
            for side in ("bare", "hooked", "hooked", "bare"):
                c, made = (bare, bare_regions) if side == "bare" else (hooked, hooked_regions)
                cost[side]["identity_p50_ms"].append(
                    p50_ms(lambda: identity_cuda(c, made), HOOK_REQUESTS))
                seq += 1
                tokens, seconds = decode_sequence(c, seq)
                if tokens != cpu_tokens:
                    raise AssertionError(f"decoder_lm ({side}): {tokens} vs CPU {cpu_tokens}")
                cost[side]["decoder_ms_per_token"].append(seconds * 1e3 / (steps + 1))
        decoder_gate("hooks", before, (len(prompt) - 1) * 4 * HOOK_ROUNDS)
        counts["hooks"] = read_counts()
        release(bare, bare_regions)
        release(hooked, hooked_regions)
        summary = {side: {k: median(v) for k, v in rows.items()} for side, rows in cost.items()}
        result["hooks"] = {"rounds": cost, "median": summary, "difference": {
            k: summary["hooked"][k] - summary["bare"][k] for k in summary["bare"]}}

        # integrity: every served output of the phase passed its contract
        overhead = integrity.stats.overhead_ns()
        result["integrity"] = {"violations": integrity.stats.violations,
                               "results": integrity.stats.results,
                               "checks": integrity.stats.checks,
                               "overhead_ns": overhead}
        if integrity.stats.violations or not integrity.stats.results:
            raise AssertionError(f"integrity: {result['integrity']}")

        # /metrics: the server's counts are the executions the phase caused
        with urllib.request.urlopen(f"http://{http_server.url}/metrics", timeout=60) as resp:
            text = resp.read().decode()
        metrics = {}
        for model in ("simple", "identity_fp32", "decoder_lm", "densenet_onnx"):
            stats = core.statistics(model)["model_stats"][0]
            row = {}
            for metric, want_value in (
                    ("inference_count", stats["inference_count"]),
                    ("execution_count", stats["execution_count"]),
                    ("request_success_count", stats["inference_stats"]["success"]["count"])):
                match = re.search(rf'^client_tpu_server_{metric}{{model="{model}"}} (\S+)$',
                                  text, re.M)
                got = float(match.group(1)) if match else None
                row[metric] = got
                if got != want_value:
                    raise AssertionError(f"/metrics {metric} of {model}: {got}, the "
                                         f"statistics say {want_value}")
            metrics[model] = row
        identity_sent = SPLIT_REQUESTS * 2 + 4 * HOOK_ROUNDS * HOOK_REQUESTS
        if metrics["identity_fp32"]["request_success_count"] != identity_sent:
            raise AssertionError(f"/metrics identity_fp32 successes "
                                 f"{metrics['identity_fp32']} != {identity_sent} sent")
        result["metrics"] = {"models": metrics, "identity_sent": identity_sent,
                             "lines": len(text.splitlines())}

        # the data-plane counters: the creates, registers and destroys made
        snap = recorder.snapshot()
        fam = snap["families"]["cuda"]
        registers = snap["rpcs"].get("cuda.register.ok", 0)
        unregisters = snap["rpcs"].get("cuda.unregister.ok", 0)
        result["dataplane"] = {"cuda": fam, "registers": registers,
                               "unregisters": unregisters, "made": dict(dp)}
        if (fam["created"] != dp["created"] or fam["destroyed"] != dp["destroyed"]
                or registers != dp["registered"] or unregisters != dp["registered"]
                or fam["regions"] != 0 or fam["bytes_resident"] != 0
                or fam["bytes_peak"] != dp["peak"]
                or fam["map_writes"] != 2 * dp["requests"]
                or fam["map_reads"] != 2 * dp["requests"]):
            raise AssertionError(f"the cuda data-plane counters: {result['dataplane']}")
    finally:
        install_dataplane(previous_recorder)
        for c in clients:
            c.close()
        http_proxy.stop()
        grpc_proxy.stop()
        http_server.stop()
        grpc_server.stop()
        core.model("decoder_lm_batched").unload()
    for path, wanted in expected.items():
        if counts[path] != {name: wanted.get(name, 0) for name in COUNTERS}:
            raise AssertionError(f"launches on the resilience phase's {path} path: "
                                 f"{counts[path]}, expected {wanted}")
    result["launch_counts"] = counts
    return result


# ---------------------------------------------------------------------------
# phase 7: the measurement harness (perf, genai_perf, trace) on the served
# paths, over the shm arena's cuda family
# ---------------------------------------------------------------------------

# the sizes phase 7 runs at; the CPU rehearsal in the tests passes smaller ones
HarnessSize = collections.namedtuple("HarnessSize", [
    "identity_bytes", "image", "vision_classes", "vision_width", "seq", "requests",
    "concurrency", "prompt", "output", "sessions", "replay"])
HARNESS = HarnessSize(
    identity_bytes=4 * MIB, image=(224, 224, 3), vision_classes=VISION_CLASSES,
    vision_width=VISION_WIDTH, seq=8192, requests=100, concurrency=(1, 2, 4), prompt=8,
    output=16, sessions=8,
    replay="mixed:duration_s=3,rate=30,stream_fraction=0.2,seq_fraction=0.15,"
           "output_mean=4,max_output=6")


def arena_regions_expected(arena, nbytes, workers):
    """The regions an arena carves for ``workers`` workers that each hold
    one lease of every size in ``nbytes`` at once: a size class carves
    ``region_target_bytes // class`` slabs a region (one above the
    target, at most ``max_slabs_per_region``), whatever the requests."""
    classes = collections.Counter(arena._class_for(n) for n in nbytes)
    total = 0
    for size, leases in classes.items():
        slabs = 1
        if size <= arena.region_target_bytes:
            slabs = max(1, min(arena.max_slabs_per_region, arena.region_target_bytes // size))
        total += -(-workers * leases // slabs)
    return total


class CountingGenAiRunner(GenAiPerfRunner):
    """``GenAiPerfRunner`` that also counts the tokens its clients received
    (the rows report rates, not counts)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.tokens = 0
        self._tokens_lock = threading.Lock()

    def _count(self, sess):
        with self._tokens_lock:
            self.tokens += sess.tokens

    def _run_decoupled_session(self, client, infer_input, sess, responses, rng):
        super()._run_decoupled_session(client, infer_input, sess, responses, rng)
        self._count(sess)

    def _run_sequence_session(self, client, infer_input, sess, responses, sequence_id, rng):
        try:
            super()._run_sequence_session(client, infer_input, sess, responses, sequence_id, rng)
        finally:
            self._count(sess)

    def _run_generate_session(self, client, sess, rng):
        super()._run_generate_session(client, sess, rng)
        self._count(sess)


def serve_harness(device="cuda", size=HARNESS):
    """Phase 7: the port's measurement harness against its own servers on
    ``device`` (the default zoo, the image ensemble and the long-context
    encoder in one ``ServerCore``, served over HTTP and GRPC in this
    process). ``PerfRunner`` closed loops at ``size.concurrency`` on
    identity_fp32 (none, system and cuda shm), ensemble_image and
    long_context_encoder (cuda shm), one open-loop poisson rate on
    identity_fp32 over cuda shm at half the closed loop's rate at
    concurrency 1, the replay of a seeded mixed trace over HTTP, and
    ``GenAiPerfRunner`` in its three modes. Each path runs with every launch
    count set to 0 just before it and read just after, and is held to what
    the server ran (its statistics' executions, the batched model's
    rounds). Every row has 0 errors and the completed counts of the
    requests sent; the cuda rows' regions are the arena's size classes,
    not the requests, and none stays resident after the arenas close.

    On a CPU ``device`` the wrappers run their plain versions and launch
    nothing, so the launch gate expects zeros there; ``expected_launches``
    in the result says what the card would launch. The script runs this
    phase only on the card."""
    on_card = torch.device(device).type == "cuda"
    encoder = LongContextEncoderModel(device=device)
    core = ServerCore(default_model_zoo(device)
                      + build_image_ensemble(size.vision_classes, size.vision_width,
                                             device=device)
                      + [encoder], device=device)
    layers = core.model("decoder_lm").LAYERS
    batched = core.model("decoder_lm_batched")
    http_server = HttpInferenceServer(core).start()
    grpc_server = GrpcInferenceServer(core, max_workers=2 * BATCH_SEQS + 8).start()
    previous_recorder = dataplane()
    recorder = enable_dataplane()
    result = {"size": size._asdict(), "perf": {}, "genai": {}}
    counts = {}
    expected = {}
    runners = []

    def stat(model, key="execution_count"):
        stats = core.statistics(model)["model_stats"][0]
        return (stats["inference_stats"]["success"]["count"] if key == "success"
                else stats[key])

    def closed_loop(name, url, protocol, model, mode, shapes, kernel, per_request):
        """A sweep at ``size.concurrency``; ``kernel`` launches ``per_request``
        times an execution of ``model``."""
        runner = PerfRunner(url, protocol, model, mode, shapes, device=device)
        runners.append(runner)
        executed, succeeded = stat(model), stat(model, "success")
        reset_counts()
        rows = [runner.run(c, size.requests) for c in size.concurrency]
        counts[name] = read_counts()
        executions = stat(model) - executed
        successes = stat(model, "success") - succeeded
        sent = sum(row["requests"] + row["errors"] + row["shed"] for row in rows)
        for row in rows:
            if row["errors"] or row["shed"]:
                raise AssertionError(f"perf {name} c={row['concurrency']}: {row['errors']} "
                                     f"errors, {row['shed']} shed ({row['error_sample']})")
        if successes != sent or sum(row["requests"] for row in rows) != sent:
            raise AssertionError(f"perf {name}: the server counted {successes} successes "
                                 f"of {sent} requests sent")
        expected[name] = {kernel: per_request * executions} if kernel else {}
        if mode != "none":
            arena = runner._arena
            made = sum(row["client_shm"]["regions_created"] for row in rows)
            want = arena_regions_expected(
                arena, [data.nbytes for _, _, _, data in runner._tensors]
                + list(runner._output_sizes.values()), max(size.concurrency))
            if made != want or arena.stats()["regions_created"] != want or made >= sent:
                raise AssertionError(f"perf {name}: {made} regions created (the arena "
                                     f"{arena.stats()['regions_created']}) for {sent} "
                                     f"requests, its size classes need {want}")
            if any(row["client_shm"]["arena"]["leased_bytes"] for row in rows):
                raise AssertionError(f"perf {name}: leases held after a run: {rows}")
        result["perf"][name] = {"rows": rows, "executions": executions, "sent": sent}
        return runner, rows

    try:
        identity_shape = {"INPUT0": [1, size.identity_bytes // 4]}
        for mode in ("none", "system", "cuda"):
            runner, rows = closed_loop(f"identity_fp32 {mode}", http_server.url, "http",
                                       "identity_fp32", mode, identity_shape, None, 0)
            if mode == "cuda":
                identity_runner, identity_c1 = runner, rows[0]
        closed_loop("identity_fp32 cuda grpc", grpc_server.url, "grpc", "identity_fp32",
                    "cuda", identity_shape, None, 0)
        closed_loop("ensemble_image cuda", http_server.url, "http", "ensemble_image", "cuda",
                    {"IMAGE": list(size.image)}, "normalize_image", 1)
        closed_loop(f"long_context_encoder S={size.seq} cuda", http_server.url, "http",
                    "long_context_encoder", "cuda", {"sequence": [size.seq, encoder.encoder.dim]},
                    "flash_attention", 1)

        # the open loop at half the closed loop's rate at concurrency 1
        rate = identity_c1["infer_per_sec"] / 2
        succeeded = stat("identity_fp32", "success")
        reset_counts()
        row = identity_runner.run_rate(rate, size.requests, "poisson", pool_size=4)
        counts["identity_fp32 cuda poisson"] = read_counts()
        expected["identity_fp32 cuda poisson"] = {}
        if (row["errors"] or row["requests"] != size.requests or row["issued"] != size.requests
                or stat("identity_fp32", "success") - succeeded != size.requests):
            raise AssertionError(f"perf identity_fp32 poisson at {rate}/s: {row}")
        result["perf"]["identity_fp32 cuda poisson"] = {"rows": [row], "rate": rate}

        # every arena closed: no region of the phase stays resident
        for runner in runners:
            if runner._arena is not None:
                runner._arena.close()
        snap = recorder.snapshot()["families"]
        result["dataplane"] = {fam: snap[fam] for fam in ("system", "cuda")}
        for fam in ("system", "cuda"):
            if snap[fam]["regions"] or snap[fam]["bytes_resident"]:
                raise AssertionError(f"{fam} regions resident after the arenas closed: "
                                     f"{snap[fam]}")

        # the replay of a seeded trace over HTTP
        trace = trace_mod.generate(size.replay, seed=0)
        streams = [r for r in trace.records if r.kind == "generate_stream"]
        # warmup sends the first record of each kind once more
        stepped = sum(r.prompt_tokens + r.output_tokens - 1 for r in streams[:1] + streams)
        replayer = PerfRunner(http_server.url, "http", "simple", device=device)
        reset_counts()
        row = replayer.run_trace(trace, replay_workers=16, slos=["error_rate<0.1%"])
        counts["trace replay"] = read_counts()
        expected["trace replay"] = {"decode_attention": stepped * layers}
        if row["errors"] or row["requests"] != len(trace.records) or not row["slo_ok"]:
            raise AssertionError(f"trace replay: {row['errors']} errors, {row['requests']} of "
                                 f"{len(trace.records)} records ({row['error_sample']})")
        result["perf"]["trace replay"] = {"rows": [row], "stream_tokens_stepped": stepped}

        # genai_perf: decoupled and sequence over GRPC, generate over HTTP
        for name, url, mode, model, levels in (
                ("decoupled tiny_lm_generate", grpc_server.url, "decoupled",
                 "tiny_lm_generate", (1,)),
                ("sequence decoder_lm_batched", grpc_server.url, "sequence",
                 "decoder_lm_batched", (1, BATCH_SEQS)),
                ("generate tiny_lm_generate", http_server.url, "generate",
                 "tiny_lm_generate", (1,))):
            for concurrency in levels:
                sessions = max(size.sessions, concurrency)
                path = f"{name} c={concurrency}"
                genai = CountingGenAiRunner(url, model, mode, size.prompt, size.output)
                executed = stat(model)
                rounds = sum(batched.batch_histogram.values())
                reset_counts()
                row = genai.run(concurrency, sessions)
                counts[path] = read_counts()
                executions = stat(model) - executed
                if mode == "sequence":
                    # a launch a layer a round, at B = slots
                    launched = sum(batched.batch_histogram.values()) - rounds
                    want_executions = sessions * size.output
                else:
                    launched = executions * (size.prompt + size.output - 1)
                    want_executions = sessions
                expected[path] = {"decode_attention": launched * layers}
                if (row["errors"] or row["incomplete"] or row["sessions"] != sessions
                        or genai.tokens != sessions * size.output
                        or executions != want_executions):
                    raise AssertionError(f"genai {path}: {row['sessions']} of {sessions} "
                                         f"sessions, {row['errors']} errors, {genai.tokens} "
                                         f"tokens, {executions} executions "
                                         f"({row['error_sample']})")
                result["genai"][path] = {"row": row, "tokens": genai.tokens,
                                         "executions": executions,
                                         "rounds": launched if mode == "sequence" else None}
    finally:
        install_dataplane(previous_recorder)
        for runner in runners:
            runner.close()
            if runner._arena is not None and not runner._arena._closed:
                runner._arena.close(force=True)
        http_server.stop()
        grpc_server.stop()
        batched.unload()
    for path, wanted in expected.items():
        want = {name: wanted.get(name, 0) if on_card else 0
                for name in COUNTERS}
        if counts[path] != want:
            raise AssertionError(f"launches on the harness phase's {path} path: "
                                 f"{counts[path]}, expected {want}")
    result["launch_counts"] = counts
    result["expected_launches"] = expected
    return result


def device_kernels(prof):
    """Device time by kernel in a torch.profiler trace, largest first."""
    kernels = []
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", 0)
        if device_us > 0 and event.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": event.key[:80], "count": event.count,
                            "total_ms": device_us / 1e3})
    kernels.sort(key=lambda k: -k["total_ms"])
    return kernels


def profile_long_context(model, seq, runs):
    """Device kernel time against wall time for ``runs`` long_context_encoder
    executes at ``seq`` on a device input, in process (no HTTP)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((seq, model.encoder.dim), generator=gen, device="cuda")

    def run():
        for _ in range(runs):
            model.execute({"sequence": x}, {})
        torch.cuda.synchronize()

    run()  # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = device_kernels(prof)
    device_ms = sum(k["total_ms"] for k in kernels) / runs
    flash_ms = sum(k["total_ms"] for k in kernels if "flash_attention" in k["name"]) / runs
    return {
        "seq": seq, "runs": runs, "wall_ms": wall_ms,
        "device_ms": device_ms if kernels else None,
        "device_idle_share": 1 - device_ms / wall_ms if kernels else None,
        "flash_attention_ms": flash_ms if kernels else None,
        "top_kernels": kernels[:6],
    }


def profile_densenet(model, runs):
    """Device kernel time against wall time for ``runs`` densenet_onnx
    executes on a device image, in process (no HTTP)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((3, 224, 224), generator=gen, device="cuda")

    def run():
        for _ in range(runs):
            model.execute({"data_0": x}, {})
        torch.cuda.synchronize()

    run()  # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = device_kernels(prof)
    device_ms = sum(k["total_ms"] for k in kernels) / runs
    return {
        "runs": runs, "wall_ms": wall_ms,
        "device_ms": device_ms if kernels else None,
        "device_idle_share": 1 - device_ms / wall_ms if kernels else None,
        "kernel_launches_per_request": (sum(k["count"] for k in kernels) / runs
                                        if kernels else None),
        "top_kernels": kernels[:8],
    }


def profile_decode(decoder, prompt, steps):
    """Device kernel time against wall time for the decoder_lm request loop,
    run in process (no HTTP), from a torch.profiler trace."""
    def direct(tokens, start, end):
        out = decoder.execute({"TOKENS": np.array([tokens], dtype=np.int32)},
                              {"sequence_id": 29, "sequence_start": start, "sequence_end": end})
        return out["LOGITS"], int(out["NEXT_TOKEN"][0, 0])

    drive_decoder(direct, prompt, steps)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive_decoder(direct, prompt, steps)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive_decoder(direct, prompt, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tokens = len(prompt) + steps
    kernels = device_kernels(prof)
    device_ms = sum(k["total_ms"] for k in kernels)
    attention = [k for k in kernels if "decode_attention" in k["name"]]
    attention_ms = sum(k["total_ms"] for k in attention)
    attention_launches = sum(k["count"] for k in attention)
    return {
        "tokens": tokens,
        "wall_ms_per_token": plain_wall_ms / tokens,
        "profiled_wall_ms_per_token": wall_ms / tokens,
        "device_ms_per_token": device_ms / tokens if kernels else None,
        # kernel time is the same with the profiler on; its host cost is not
        "device_idle_share": 1 - device_ms / plain_wall_ms if kernels else None,
        "decode_attention_ms_per_token": attention_ms / tokens if kernels else None,
        "decode_attention_ms_per_launch": (attention_ms / attention_launches
                                           if attention_launches else None),
        "top_kernels": kernels[:8],
    }


def small_kernel_times():
    """The four small kernels timed at the served and the large shapes
    (per call, on the device, plain, library, bound, and at the served
    shapes the host time per call), and the host time per call of the two
    attention wrappers at their served shapes; each row logged. Only the
    public wrappers and plain versions are called, so the same function
    times an earlier tree of the port (``--kernel-times``)."""
    quant_timed = [time_quantize(8192, 200), time_quantize(16 * MIB, 20)]
    dequant_bf16 = time_dequantize_to(16 * MIB, torch.bfloat16, 20)
    library = ("none" if dequant_bf16["library_ms"] is None
               else f"{dequant_bf16['library_ms']:.4f} ms")
    log(f"time dequantize_int8 n={dequant_bf16['n']} bf16 out: kernel {dequant_bf16['ms']:.4f} "
        f"ms ({ms_text(dequant_bf16['device_ms'])} on the device), plain "
        f"{dequant_bf16['plain_ms']:.4f} ms, library {library} (torch.mul(q, scale, out=o) "
        f"{dequant_bf16['library_candidate_ms']:.4f} ms, {dequant_bf16['library_mismatches']} "
        f"bit mismatches; {ms_text(dequant_bf16['library_device_ms'])} on the device), "
        f"{bound_text(dequant_bf16)}")
    for row in quant_timed:
        for name in ("quantize", "dequantize"):
            t = row[name]
            library = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            extra = ""
            if "library_candidate_ms" in t:
                extra = (f" (torch.quantize_per_tensor {t['library_candidate_ms']:.4f} ms, "
                         f"{t['library_mismatches']} int8 mismatches"
                         + (f", {t['library_mismatches_wire']} on the wire input"
                            if "library_mismatches_wire" in t else "")
                         + f"; at {t['library_mismatch_at'][:3]})")
            log(f"time {name}_int8 n={row['n']} fp32: kernel {t['ms']:.4f} ms "
                f"({ms_text(t['device_ms'])} on the device{host_text(t, 'host_us')}), plain "
                f"{t['plain_ms']:.4f} ms, library {library}{extra} "
                f"({ms_text(t['library_device_ms'])} on the device"
                f"{host_text(t, 'library_host_us')}), {bound_text(t)}")
        ceiling = row["dequantize"].get("write_ceiling")
        if ceiling:
            log(f"time write ceiling {ceiling['call']} n={ceiling['n']}: {ceiling['ms']:.4f} "
                f"ms ({ms_text(ceiling['device_ms'])} on the device), "
                f"{bound_text(ceiling)}")
    # the image_client's input first: the row of the kernels line
    norm_timed = [time_normalize((224, 224, 3), torch.float32, 200),
                  time_normalize((224, 224, 3), torch.uint8, 200),
                  time_normalize((16 * MIB,), torch.float32, 20),
                  time_normalize((16 * MIB,), torch.uint8, 20)]
    softmax_timed = [time_softmax((1, VISION_CLASSES), 200),
                     time_softmax((16384, VISION_CLASSES), 20)]
    for name, timed_rows in (("normalize_image", norm_timed),
                             ("softmax_probabilities", softmax_timed)):
        for row in timed_rows:
            library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
            extra = ""
            if "library_mismatches" in row:
                extra = (f" (torch.add(shift, x, alpha=scale) {row['library_candidate_ms']:.4f} "
                         f"ms, {row['library_mismatches']} bit mismatches)")
            log(f"time {name} {row['shape']} {row.get('in', row.get('dtype'))}: kernel "
                f"{row['ms']:.4f} ms ({ms_text(row['device_ms'])} on the device"
                f"{host_text(row, 'host_us')}), plain {row['plain_ms']:.4f} ms, "
                f"library {library}{extra} ({ms_text(row['library_device_ms'])} on the device"
                f"{host_text(row, 'library_host_us')}), {bound_text(row)}")
    attention = attention_host_us()
    for name, us in attention.items():
        log(f"host {name} at its served shape: {us:.3f} us per call")
    return {"quantize": quant_timed, "dequantize_bf16": dequant_bf16, "normalize": norm_timed,
            "softmax": softmax_timed, "attention_host_us": attention}


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def host_text(row, key) -> str:
    return f", {row[key]:.2f} us on the host" if key in row else ""


def device_share(row) -> None:
    """Store in ``row`` the share of its bound that its device time
    reaches (None where the profiler gave no device time)."""
    row["device_share_of_bound"] = (None if row.get("device_ms") is None
                                    else row["bound_ms"] / row["device_ms"])


def bound_text(row) -> str:
    """The bound and the shares of it that the per-call and the device
    times reach."""
    share = row.get("device_share_of_bound")
    device = "" if share is None else f", {share:.1%} on the device"
    return (f"bound {row['bound_ms']:.5f} ms (bytes; {row['bound_ms'] / row['ms']:.1%} of "
            f"bound per call{device})")


def attention_host_us():
    """Host time per call (enqueue, no sync) of the decode and flash
    wrappers at their served shapes: the decoder's step (1, 4, 128, 32) bf16
    at pos 11 and the encoder's (1, 100, 4, 16) fp32."""
    q, k, v = attention_inputs(1, 4, 128, 32, torch.bfloat16, seed=7)
    pos = torch.tensor([11], dtype=torch.int32, device="cuda")
    fq, fk, fv = flash_inputs((1, 100, 4, 16), torch.float32, seed=99)
    return {"decode_attention": host_us(lambda: da.decode_attention(q, k, v, pos)),
            "flash_attention": host_us(lambda: flash_attention(fq, fk, fv))}


def host_breakdown(calls: int = 10000):
    """Host time of each piece of one normalize_image call at the
    image_client's (224, 224, 3) uint8 -> fp32, median over ``calls`` calls
    each: the pieces of the launch path the five wrappers had before they
    shared ``_kernels.launch`` ("before", rebuilt here call for call) and
    those of the shared path ("after"), then the whole wrapper."""
    x = image_input((224, 224, 3), torch.uint8, seed=3)
    scale, shift = INCEPTION
    out = ops.normalize_image(x, scale, shift, torch.float32)
    dev = x.device
    index = x.get_device()
    n = x.numel()
    fn = _kernels.function("normalize_image", "normalize_image_launch", nz._ARGTYPES)
    blocks = nz.normalize_plan(n, x.dtype, torch.float32, True, sms()).blocks
    counter = type(nz.LAUNCHES)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    in_codes, out_codes = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}, {
        torch.float32: 0, torch.bfloat16: 1}

    def before_device_check():
        with (nullcontext() if dev.index is None or dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev)):
            pass

    pieces = [
        ("before", "checks (dtype, out dtype, contiguity, x.device.type)",
         lambda: (x.dtype not in in_codes, torch.float32 not in out_codes,
                  x.is_contiguous(), x.device.type)),
        ("before", "torch.empty(x.shape, dtype, device=x.device)",
         lambda: torch.empty(x.shape, dtype=torch.float32, device=x.device)),
        ("before", "_kernels.function lookup",
         lambda: _kernels.function("normalize_image", "normalize_image_launch",
                                   nz._ARGTYPES)),
        ("before", "device check: x.device, current_device, nullcontext",
         before_device_check),
        ("before", "scale and shift rounded by np.float32",
         lambda: (float(np.float32(scale)), float(np.float32(shift)))),
        ("before", "torch.cuda.current_stream(x.device).cuda_stream",
         lambda: torch.cuda.current_stream(x.device).cuda_stream),
        ("both", "ctypes call (launches the kernel)",
         lambda: fn(x.data_ptr(), out.data_ptr(), n, 2, 0, scale, shift, blocks, stream)),
        ("both", "launch counter (a lock)", counter.add),
        ("after", "checks (dict.get x2, contiguity, is_cuda)",
         lambda: (in_codes.get(x.dtype), out_codes.get(torch.float32), x.is_contiguous(),
                  x.is_cuda)),
        ("after", "torch.empty_like(x, dtype)", lambda: torch.empty_like(x, dtype=torch.float32)),
        ("after", "x.get_device()", x.get_device),
        ("after", "normalize_plan + sm_count",
         lambda: nz.normalize_plan(n, x.dtype, torch.float32, True, _kernels.sm_count(index))),
        ("after", "raw stream: torch._C._cuda_getCurrentRawStream(index)",
         lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("after", "device check: index == current_device()",
         lambda: index == torch.cuda.current_device()),
        ("after", "the whole wrapper (ops.normalize_image)",
         lambda: ops.normalize_image(x, scale, shift, torch.float32)),
    ]
    return [{"side": side, "piece": piece, "calls": calls, "us": host_us(call, calls)}
            for side, piece, call in pieces]


def main(argv) -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = device_line()
    log(f"device: {smi}")

    seconds, ptxas = build_kernels()
    log(f"build: {seconds:.2f} s")
    for line in ptxas:
        log(f"  ptxas: {line}")
    if argv == ["--kernel-times"]:
        # the small kernels' timings alone, for the tree this file sits in
        # (copied into another tree of the port, it times that one)
        small = small_kernel_times()
        log(smi)
        log(json.dumps({"kernel_times": small, "device": kind}))
        return 0
    if argv:
        log(f"chip_smoke: unknown arguments {argv} (none, or --kernel-times)")
        return 2
    smem = _kernels.function("flash_attention", "flash_attention_smem_bytes",
                             (ctypes.c_int, ctypes.c_int))
    log("  flash_attention dynamic shared memory per block (bytes): "
        + ", ".join(f"{name} D={dim} {smem(code, dim)}"
                    for name, code in (("bf16", 1), ("fp32", 0)) for dim in (16, 32, 64, 128)))

    rows, worst = check_decode_attention()
    for row in rows:
        split = (f" splits {row['splits']}; vs the split plain version "
                 f"{row['max_abs_err_vs_split_plain']:.3g}" if "splits" in row else "")
        log(f"kernel decode_attention {row['case']} {row['shape']} pos {row['pos']} "
            f"{row['dtype']}: max_abs_err {row['max_abs_err']:.3g} (tol {row['tol']}{split})")
    # the decoder's shape mid-run (the kernels line's row) and at a full cache
    timed = [time_decode_attention((1, 4, 128, 32), pos, 200) for pos in ([11], [127])]
    for shape, iters in (((8, 8, 2048, 128), 50), ((8, 8, 8192, 128), 20),
                         ((16, 8, 4096, 128), 20)):
        timed.append(time_decode_attention(shape, [shape[2] - 1] * shape[0], iters))
    batched_timed = time_decode_attention(BATCHED_SHAPE, BATCHED_POS, 200)
    for row in timed + [batched_timed]:
        device = ("not measured" if row["device_ms"] is None
                  else f"{row['device_ms']:.4f} ms")
        pos = row["pos"] if len(set(row["pos"])) > 1 else row["pos"][0]
        log(f"time decode_attention {row['shape']} pos {pos} bf16 splits "
            f"{row['splits']}: kernel {row['ms']:.4f} ms per call ({device} on the "
            f"device), plain {row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_ms'] / row['ms']:.1%} of bound)")

    flash_rows = check_flash_attention()
    for row in flash_rows:
        log(f"kernel flash_attention {row['case']} {row['shape']} {row['dtype']} "
            f"causal={row['causal']} blocks {row['blocks']}: max_abs_err "
            f"{row['max_abs_err']:.3g} (atol = rtol = {row['tol']}; vs the tiled plain "
            f"version {row['max_abs_err_vs_tiled_plain']:.3g})"
            + ("" if row["dtype"] != "bfloat16" else
               f" (atol {TILED_TOLERANCE['atol']:g}, rtol {TILED_TOLERANCE['rtol']:g})"))
    # the served shape at its largest length first: the row of the kernels line
    flash_timed = [time_flash_attention((1, s, 4, 16), "float32", False, iters)
                   for s, iters in ((8192, 20), (4096, 50), (100, 200))]
    flash_timed += [time_flash_attention((4, 2048, 8, 128), "bfloat16", causal, 10)
                    for causal in (False, True)]
    for row in flash_timed:
        log(f"time flash_attention {row['shape']} {row['dtype']} causal={row['causal']}: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.1%} of bound)")

    quant_rows = check_quantize()
    log(f"kernel quantize_int8 / dequantize_int8: element exact in all {len(quant_rows)} "
        "cases (quantize fp32, bf16 and fp16 in at n = 8192, 8195, 16 Mi and unaligned, "
        "half-steps and clipping; dequantize to fp32, bf16 and fp16 over every int8 value, "
        "at n = 8192, 8195, one below and one above a whole word and a whole grid step, "
        "16 Mi, input unaligned)")
    norm_rows = check_normalize()
    log(f"kernel normalize_image: element exact in all {len(norm_rows)} cases (fp32, uint8, "
        "bf16, fp16 and int32 in; fp32, bf16 and fp16 out; INCEPTION and NONE; (224,224,3), "
        "(7,13,3), 16 Mi, unaligned, int32 past 2**24; every path one below and one above a "
        "whole vector and a whole grid step)")
    softmax_rows = check_softmax()
    for row in softmax_rows:
        if "max_rel_err" in row:
            log(f"kernel softmax_probabilities {row['shape']} {row['dtype']} "
                f"x{row['scale']:g} ({row['variant']}, {row['warps']} warps, {row['vectors']} "
                f"vectors): max_rel_err {row['max_rel_err']:.3g} (rtol {row['rtol']})")
        else:
            log(f"kernel softmax_probabilities {row['shape']} {row['case']} "
                f"({row['variant']}): as the plain version, {row['nan_rows']} NaN rows")
    tie_rows = check_ties()
    for row in tie_rows:
        log(f"ties {row['rows']} {row['shape']} k={row['k']}: card as the CPU (indices, "
            f"values and the extension's strings); torch.topk on the card ranks "
            f"{row['torch_topk_rows_in_another_order']} rows in another order")
    topk_timed = time_classification()
    for row in topk_timed:
        log(f"time classification {row['shape']} k={row['k']}: " + "; ".join(
            f"{name} {t['ms']:.4f} ms (quartiles {t['ms_quartiles'][0]:.4f}-"
            f"{t['ms_quartiles'][1]:.4f}; {ms_text(t['device_ms'])} on the device)"
            for name, t in row.items()
            if name in ("sort", "torch_topk", "sort_to_host", "topk_to_host")))
    fallback_rows = check_no_fallback()
    for row in fallback_rows:
        if "raised" in row:
            log(f"no fallback: {row['case']} raised {row['raised']}")
        else:
            log(f"unaligned views: {row['case']}: max_abs_err {row['max_abs_err']:.3g} (tol "
                f"{row['tol']}), {row['launches']} launch")
    small = small_kernel_times()
    quant_timed, norm_timed, softmax_timed = (small["quantize"], small["normalize"],
                                              small["softmax"])
    breakdown = host_breakdown()
    for piece in breakdown:
        log(f"host normalize_image (224,224,3) uint8: {piece['side']} {piece['piece']}: "
            f"{piece['us']:.3f} us per call (median of {piece['calls']})")

    served, launches = serve_and_check()
    vision, vision_launches = serve_vision(20)
    launches.update(vision_launches)
    grpc_served = serve_grpc(served, vision)
    t_phase = time.perf_counter()
    resilience = serve_resilience(served, vision)
    resilience["seconds"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    harness = serve_harness()
    harness["seconds"] = time.perf_counter() - t_phase
    for row in served["identity"]:
        log(f"identity_fp32 {row['bytes'] // MIB} MiB p50: wire {row['wire_p50_ms']:.3f} ms, "
            f"system shm {row['system_shm_p50_ms']:.3f} ms, "
            f"cuda shm {row['cuda_shm_p50_ms']:.3f} ms")
    prof = served["profile"]
    if prof["device_ms_per_token"] is None:
        log("profile: the profiler recorded no device time (not measured)")
    else:
        log(f"profile decoder_lm in process: {prof['wall_ms_per_token']:.3f} ms/token wall, "
            f"{prof['device_ms_per_token']:.4f} ms/token on the device "
            f"(idle {prof['device_idle_share']:.1%}), decode_attention "
            f"{prof['decode_attention_ms_per_token']:.4f} ms/token; top kernels "
            + ", ".join(f"{k['name'][:40]} {k['total_ms']:.3f} ms/{k['count']}"
                        for k in prof["top_kernels"][:4]))
    dec = served["decoder"]
    req = dec["client_request_ms"]
    log(f"decoder_lm over HTTP per request: {req['total_request']:.3f} ms total, "
        f"{req['send']:.3f} ms send to response headers, {req['receive']:.3f} ms body read")
    log(f"decoder_lm tokens {dec['gpu_tokens']} (cpu {dec['cpu_tokens']}), max logit diff "
        f"{dec['max_abs_logit_diff']:.4g}; tiny_lm_generate {dec['generate_tokens']}; "
        f"decode_attention launches {launches['decode_attention']} = "
        f"{dec['tokens_stepped']} tokens x {dec['layers']} layers")
    bat = served["batched"]
    log(f"decoder_lm_batched over HTTP: {BATCH_SEQS} sequences (prompts of 1-{BATCH_SEQS} "
        f"tokens, {bat['steps']} continuations each) in {bat['seconds']:.3f} s; rounds by "
        f"width {bat['histogram']}; decode_attention launches {bat['launches']} = "
        f"{bat['rounds']} rounds x {bat['layers']} layers; tokens as decoder_lm on the card "
        f"and as the CPU run; max logit diff vs CPU {bat['max_abs_logit_diff_vs_cpu']:.4g}, vs "
        f"decoder_lm on the card {bat['max_abs_logit_diff_vs_card_decoder_lm']:.4g}")
    fs = served["full_slot"]
    log(f"decoder_lm_batched full slot: a sequence at pos == MAX_LEN rode along while "
        f"another decoded {fs['tokens']} (decoder_lm {fs['decoder_lm_tokens']}, max logit diff "
        f"{fs['max_abs_logit_diff']:.4g}); its cache untouched; its next token refused "
        f"({fs['overflow_error']})")
    log(f"decoder_lm_prefill {PREFILL_ROWS}x{PREFILL_LEN}: rows bit-equal to decoder_lm on "
        f"the card; next tokens {served['prefill']['next_tokens']}")
    dg = served["disagg"]
    log(f"disagg: KV ({dg['kv_bytes']} B) in a colocated cuda shm region, on the device and "
        f"equal to the prompt's cache; kv_decode stream {dg['stream']} = tiny_lm_generate")
    log("launches by path: " + json.dumps(served["launches_by_path"]))
    for row in served["batched_timing"]:
        extra = ""
        if "device_ms_per_round" in row:
            extra = ("; profiler: not measured" if row["device_ms_per_round"] is None else
                     f"; {row['device_ms_per_round']:.4f} ms per round on the device (idle "
                     f"{row['device_idle_share']:.1%}), "
                     f"{row['decode_attention_launches_per_round']:g} decode_attention "
                     f"launches ({row['decode_attention_ms_per_round']:.4f} ms) and "
                     f"{row['kernel_launches_per_round']:g} kernels per round")
        log(f"time decoder_lm_batched in process, {row['width']} active: "
            f"{row['wall_ms_per_round']:.4f} ms per round, {row['tokens_per_s']:.1f} tokens/s"
            + extra)
    for row in served["long_context"]:
        log(f"long_context_encoder S={row['seq']} p50: wire {row['wire_p50_ms']:.3f} ms, "
            f"cuda shm {row['cuda_shm_p50_ms']:.3f} ms; max diff vs CPU run "
            f"{row['wire_max_abs_diff_vs_cpu']:.3g} (wire), "
            f"{row['cuda_shm_max_abs_diff_vs_cpu']:.3g} (cuda shm)")
    log(f"long_context_encoder flash_attention launches {launches['flash_attention']} = "
        "requests")
    lc_prof = served["long_context_profile"]
    if lc_prof["device_ms"] is None:
        log("profile long_context_encoder: the profiler recorded no device time (not measured)")
    else:
        log(f"profile long_context_encoder S={lc_prof['seq']} in process: "
            f"{lc_prof['wall_ms']:.3f} ms wall, {lc_prof['device_ms']:.3f} ms on the device "
            f"(idle {lc_prof['device_idle_share']:.1%}), flash_attention "
            f"{lc_prof['flash_attention_ms']:.3f} ms; top kernels "
            + ", ".join(f"{k['name'][:40]} {k['total_ms']:.3f} ms/{k['count']}"
                        for k in lc_prof["top_kernels"][:4]))
    int8 = served["int8"]
    log(f"int8 wire path {int8['shape']}: {int8['wire_bytes']} B on the wire vs "
        f"{int8['fp32_bytes']} B fp32, max error {int8['max_abs_err']:.6f} <= half step "
        f"{int8['bound']:.6f}, round trip p50 {int8['p50_ms']:.3f} ms; launches quantize "
        f"{launches['quantize_int8']}, dequantize {launches['dequantize_int8']} = round trips")
    req = vision["requests"]
    log(f"densenet_onnx width {VISION_WIDTH} / {VISION_CLASSES} classes "
        f"({vision['flops_per_image'] / 1e9:.3f} GFLOP per image) p50: wire "
        f"{vision['wire_p50_ms']:.3f} ms, cuda shm {vision['cuda_shm_p50_ms']:.3f} ms; "
        f"ensemble_image p50 {vision['ensemble_p50_ms']:.3f} ms; max logit diff vs CPU run "
        f"{vision['wire_max_abs_logit_diff_vs_cpu']:.4g} (wire), "
        f"{vision['cuda_shm_max_abs_logit_diff_vs_cpu']:.4g} (cuda shm), "
        f"{vision['ensemble_max_abs_logit_diff_vs_cpu']:.4g} (ensemble); top-3 "
        f"{vision['wire_top3']} (image_client), {vision['ensemble_top3']} (ensemble); "
        f"probabilities sum {vision['probabilities_sum']:.7f}")
    log(f"vision launches: normalize_image {launches['normalize_image']} = "
        f"{req['image_client']} image_client + {req['ensemble_image']} ensemble requests; "
        f"softmax_probabilities {launches['softmax_probabilities']} = {req['softmax_calls']} "
        "calls")
    dn_prof = vision["profile"]
    if dn_prof["device_ms"] is None:
        log("profile densenet_onnx: the profiler recorded no device time (not measured)")
    else:
        log(f"profile densenet_onnx in process: {dn_prof['wall_ms']:.3f} ms wall, "
            f"{dn_prof['device_ms']:.3f} ms on the device (idle "
            f"{dn_prof['device_idle_share']:.1%}), {dn_prof['kernel_launches_per_request']:.0f} "
            "kernels per request; top kernels "
            + ", ".join(f"{k['name'][:40]} {k['total_ms']:.3f} ms/{k['count']}"
                        for k in dn_prof["top_kernels"][:4]))

    # the GRPC phase, beside the HTTP phase's numbers on the same card
    card = smi.strip()
    for grpc_row, http_row in zip(grpc_served["identity"], served["identity"]):
        log(f"grpc identity_fp32 {grpc_row['bytes'] // MIB} MiB p50 (HTTP beside it): wire "
            f"{grpc_row['wire_p50_ms']:.3f} ms ({http_row['wire_p50_ms']:.3f}), system shm "
            f"{grpc_row['system_shm_p50_ms']:.3f} ms ({http_row['system_shm_p50_ms']:.3f}), "
            f"cuda shm {grpc_row['cuda_shm_p50_ms']:.3f} ms "
            f"({http_row['cuda_shm_p50_ms']:.3f}); {card}")
    adm = grpc_served["admin"]
    log(f"grpc admin: live, ready, metadata, config, {adm['repository_models']} models in the "
        f"repository index, unload/load {adm['unloaded_then_ready']}, statistics success "
        f"count {adm['simple_success_count']} = {adm['simple_sent']} simple requests sent")
    gdec = grpc_served["decoder"]
    log(f"grpc decoder_lm over one bidi stream: tokens {gdec['tokens']} = HTTP and CPU; "
        f"{gdec['ms_per_token']:.3f} ms per token (HTTP "
        f"{served['decoder']['client_request_ms']['total_request']:.3f} ms per request); "
        f"decode_attention launches {gdec['launches']} = {gdec['tokens_stepped']} tokens x "
        f"{gdec['layers']} layers; {card}")
    gbat = grpc_served["batched"]
    log(f"grpc decoder_lm_batched over {BATCH_SEQS} concurrent streams in "
        f"{gbat['seconds']:.3f} s (HTTP {served['batched']['seconds']:.3f} s); rounds by width "
        f"{gbat['histogram']}; decode_attention launches {gbat['launches']} = "
        f"{gbat['rounds']} rounds x {gbat['layers']} layers; tokens as decoder_lm on the "
        f"card; {card}")
    gimg = grpc_served["image_client"]
    log(f"grpc image_client (cuda shm in and out, normalize and softmax on the card) p50 "
        f"{gimg['cuda_shm_p50_ms']:.3f} ms (HTTP {vision['cuda_shm_p50_ms']:.3f}); top-1 "
        f"{gimg['top1']} = CPU {gimg['cpu_top1']}, max logit diff "
        f"{gimg['max_abs_logit_diff_vs_cpu']:.4g}; launches normalize_image "
        f"{grpc_served['launch_counts']['image_client']['normalize_image']} = "
        f"{gimg['requests']} requests, softmax_probabilities "
        f"{grpc_served['launch_counts']['image_client']['softmax_probabilities']} = "
        f"{gimg['softmax_calls']} calls; {card}")
    for name, row in grpc_served["aio"].items():
        log(f"{name}: {row['requests']} requests (simple, identity_fp32 over cuda shm) "
            f"through asyncio.gather in {row['seconds']:.3f} s; outputs as expected and "
            f"equal across the two aio clients; {card}")
    grpc_counts = grpc_served["launch_counts"]

    # the resilience phase, with the card's name and power limit on each line
    log(f"resilience phase: {resilience['seconds']:.1f} s")
    for name in ("image_client under flap", "image_client under reset@N"):
        row = resilience[name]
        log(f"resilience {name}: {row['requests']} requests, {row['errors']} errors, policy "
            f"{row['policy']}, {row['faulted_connections']} faulted connections, "
            f"{row['server_executions']} densenet_onnx executions; top-1 {row['top1'][0]} = "
            f"CPU {row['cpu_top1']}, max logit diff {row['max_abs_logit_diff_vs_cpu']:.4g}; "
            f"{card}")
    row = resilience["decoder_lm under reset@N"]
    log(f"resilience decoder_lm sequence under reset@N: tokens before the fault "
        f"{row['tokens_before_fault']} = CPU; the faulted request ({row['fault_domain']}) "
        f"made {row['faulted_call_attempts']} attempt (never re-sent); "
        f"{row['server_executions']} executions of {row['requests_sent']} requests sent")
    row = resilience["grpc stream auto_reconnect"]
    log(f"resilience grpc stream auto_reconnect: {row['reconnects']} StreamReconnected, "
        f"abandoned {row['abandoned_request_ids']}, re-sent {row['resent_request_ids']}; "
        f"re-driven tokens {row['tokens']} = CPU; {row['server_executions']} executions; "
        f"StreamChecker events per wire stream {row['stream_checker_events']}")
    row = resilience["breaker"]
    log(f"resilience breaker under blackhole: {row['state_after_faults']} after 4 "
        f"timeouts, transitions {row['transitions']}, fast-fail opened "
        f"{row['fast_fail_connections']} connections, policy {row['policy']}")
    row = resilience["flight"]
    log(f"flight recorder: retained {row['retained']} for {row['failures_seen']} failures "
        f"seen by the caller")
    for name, row in resilience["split"].items():
        phases = ", ".join(f"{k} {v:.3f}" for k, v in row["client_ms_p50"].items())
        log(f"round trip {name} ({row['requests']} requests, p50 ms): client {phases}, "
            f"total {row['client_total_ms_p50']:.3f}; server queue "
            f"{row['server_queue_ms_p50']:.3f}, compute {row['server_compute_ms_p50']:.3f}, "
            f"total {row['server_total_ms_p50']:.3f}; {card}")
    prof_row = resilience["split"]["image_client cuda shm"]["profiled_request"]
    log(f"one image_client request (cuda shm): server compute_ns "
        f"{prof_row['server_compute_ms']:.3f} ms (host time of model.execute), server total "
        f"{prof_row['server_total_ms']:.3f} ms, device time (profiler, all device activity) "
        f"{ms_text(prof_row['device_ms'])}, client {prof_row['client_total_ms']:.3f} ms; "
        f"{card}")
    hooks = resilience["hooks"]
    log(f"hooks' host cost ({HOOK_ROUNDS} interleaved rounds, medians): identity_fp32 4 MiB "
        f"cuda shm p50 {hooks['median']['bare']['identity_p50_ms']:.4f} ms bare, "
        f"{hooks['median']['hooked']['identity_p50_ms']:.4f} ms with telemetry, resilience "
        f"and integrity (+{hooks['difference']['identity_p50_ms']:.4f}); decoder_lm "
        f"{hooks['median']['bare']['decoder_ms_per_token']:.4f} ms per token bare, "
        f"{hooks['median']['hooked']['decoder_ms_per_token']:.4f} hooked "
        f"(+{hooks['difference']['decoder_ms_per_token']:.4f}); {card}")
    row = resilience["integrity"]
    log(f"integrity: {row['results']} results, {row['checks']} checks, {row['violations']} "
        f"violations; overhead p50 {row['overhead_ns']['p50']:.0f} ns, p99 "
        f"{row['overhead_ns']['p99']:.0f} ns per result; {card}")
    log("metrics: /metrics counts = the statistics: " + json.dumps(
        resilience["metrics"]["models"]))
    row = resilience["dataplane"]
    log(f"dataplane cuda: {row['cuda']} = {row['made']['created']} creates, "
        f"{row['made']['registered']} registers, {row['made']['destroyed']} destroys, peak "
        f"{row['made']['peak']} B, {row['made']['requests']} requests x 2 map writes and reads")
    log("resilience launches by path: " + json.dumps(resilience["launch_counts"]))
    res_counts = resilience["launch_counts"]

    def resilience_launches(kernel):
        return {path: row[kernel] for path, row in res_counts.items() if row[kernel]}

    # the harness phase: each row's rate and latency, with the card's name
    log(f"harness phase: {harness['seconds']:.1f} s")
    for name, entry in harness["perf"].items():
        for row in entry["rows"]:
            lm = row["latency_ms"]
            if "concurrency" in row:
                level, rate = f"concurrency {row['concurrency']}", row["infer_per_sec"]
            elif "request_rate" in row:
                level = f"{row['distribution']} rate {row['request_rate']:.1f}/s"
                rate = row["achieved_rate"]
            else:
                level = f"{row['trace']['records']} records {row['trace']['kinds']}"
                rate = row["achieved_rate"]
            shm = row.get("client_shm")
            extra = ("" if shm is None else
                     f"; {shm['regions_created']} regions created, arena hit rate "
                     f"{shm['arena']['hit_rate']}, {shm['arena']['registrations_issued']} "
                     "registrations issued")
            log(f"perf {name} {level}: {row['requests']} requests, {row['errors']} errors, "
                f"{rate} infer/s, p50 {lm['p50']} ms, p99 {lm['p99']} ms{extra}; {card}")
    for path, entry in harness["genai"].items():
        row = entry["row"]
        log(f"genai {path}: {row['sessions']} sessions, {entry['tokens']} tokens, "
            f"{row['errors']} errors; ttft p50 {row['ttft_ms']['p50']} ms p99 "
            f"{row['ttft_ms']['p99']} ms, inter-token p50 {row['inter_token_ms']['p50']} ms "
            f"p99 {row['inter_token_ms']['p99']} ms, {row['output_tokens_per_sec']} tokens/s; "
            f"{card}")
    log("harness dataplane after the arenas closed: " + json.dumps(harness["dataplane"]))
    log("harness launches by path: " + json.dumps(harness["launch_counts"]))
    harness_counts = harness["launch_counts"]

    def harness_launches(kernel):
        return {path: row[kernel] for path, row in harness_counts.items() if row[kernel]}

    main_row = timed[0]
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/decode_attention.cu",
        "replaces": "client_tpu/ops/decode_attention.py:121",
        "launches": launches["decode_attention"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        # device time alone per launch on the served decode step (profiler);
        # "ms" above is a wrapper call back to back, host launch cost included
        "device_ms": served["profile"]["decode_attention_ms_per_launch"],
        "redesigned": REDESIGNED["decode_attention"],
        "host_us": small["attention_host_us"]["decode_attention"],
        "shape": main_row["shape"],
        "pos": main_row["pos"],
        "splits": main_row["splits"],
        "at_shapes": timed[1:],
        # launches is the decoder path's; every decoder-family path's here
        "launches_by_path": served["launches_by_path"],
        "grpc_launches_by_path": {
            "decoder": grpc_counts["decoder"]["decode_attention"],
            "decoder_lm_batched": grpc_counts["decoder_lm_batched"]["decode_attention"]},
        "resilience_launches_by_path": resilience_launches("decode_attention"),
        "harness_launches_by_path": harness_launches("decode_attention"),
        "batched_shape": batched_timed,
    }]
    flash_row = flash_timed[0]
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/flash_attention.cu",
        "replaces": "client_tpu/ops/flash_attention.py:142",
        "launches": launches["flash_attention"],
        "max_abs_err": flash_row["max_abs_err"],
        "ms": flash_row["ms"],
        "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
        "redesigned": REDESIGNED["flash_attention"],
        "host_us": small["attention_host_us"]["flash_attention"],
        "harness_launches_by_path": harness_launches("flash_attention"),
        "shape": flash_row["shape"],
        "dtype": flash_row["dtype"],
        "at_shapes": flash_timed[1:],
    })
    wire_row = quant_timed[0]
    for name, replaces, note in (
            ("quantize_int8", "client_tpu/ops/__init__.py:170",
             "library_ms is torch.quantize_per_tensor(x, scale, 0, torch.qint8) where its "
             "int_repr() gave the kernel's int8 values on the timed input and on the int8 "
             "wire path's input, else null with library_mismatches (and _wire) the count "
             "of values that differ and library_mismatch_at (kernel, library, x / scale) "
             "where"),
            ("dequantize_int8", "client_tpu/ops/__init__.py:183",
             "library_ms is q * scale (int8 times a Python float gives float32)")):
        t = wire_row[name.split("_")[0]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "client_tpu_torch/csrc/quantize_int8.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": t["library_ms"],
            "library_note": note,
            **{key: t[key] for key in ("library_mismatches", "library_mismatches_wire",
                                       "library_mismatch_at", "library_candidate_ms",
                                       "library_device_ms", "host_us", "library_host_us")
               if key in t},
            # device time alone per launch (profiler); "ms" is a wrapper call
            # back to back, host launch cost included
            "device_ms": t["device_ms"],
            **({"redesigned": REDESIGNED[name]} if name in REDESIGNED else {}),
            "n": wire_row["n"],
            "at_shapes": [{"n": row["n"], **row[name.split("_")[0]]}
                          for row in quant_timed[1:]]
            + ([small["dequantize_bf16"]] if name == "dequantize_int8" else []),
        })
    for name, source, replaces, timed_rows, note in (
            ("normalize_image", "normalize_image.cu", "client_tpu/ops/__init__.py:44",
             norm_timed,
             "library_ms is torch.add(shift, x, alpha=scale) (a 0-dim fp32 shift; fp32 or "
             "uint8 x) where it gave the kernel's bits, else null with library_mismatches "
             "the count of elements whose bits differ"),
            ("softmax_probabilities", "softmax.cu", "client_tpu/ops/__init__.py:138",
             softmax_timed, "library_ms is torch.softmax(x, -1, dtype=torch.float32)")):
        row = timed_rows[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"client_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_note": note,
            **{key: row[key] for key in ("library_mismatches", "library_device_ms",
                                         "host_us", "library_host_us") if key in row},
            "device_ms": row["device_ms"],
            "redesigned": REDESIGNED[name],
            "grpc_launches": grpc_counts["image_client"][name],
            "resilience_launches_by_path": resilience_launches(name),
            "harness_launches_by_path": harness_launches(name),
            "shape": row["shape"],
            "at_shapes": timed_rows[1:],
        })
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_seconds": seconds, "ptxas": ptxas,
                   "checks": rows, "worst_err": worst, "timed": timed,
                   "batched_timed": batched_timed,
                   "flash_checks": flash_rows, "flash_timed": flash_timed,
                   "quantize_checks": quant_rows, "quantize_timed": quant_timed,
                   "dequantize_bf16_timed": small["dequantize_bf16"],
                   "tie_checks": tie_rows, "classification_timed": topk_timed,
                   "no_fallback_checks": fallback_rows,
                   "normalize_checks": norm_rows, "normalize_timed": norm_timed,
                   "softmax_checks": softmax_rows, "softmax_timed": softmax_timed,
                   "attention_host_us": small["attention_host_us"],
                   "host_breakdown": breakdown,
                   "served": served, "vision": vision, "grpc": grpc_served,
                   "resilience": resilience, "harness": harness,
                   "kernels": kernels}, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
