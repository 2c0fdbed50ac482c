#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``client_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: the ``nvidia-smi`` name and power-limit line;
2. build: every kernel under ``client_tpu_torch/csrc`` (decode_attention,
   flash_attention, quantize_int8) built from source with nvcc into
   ``build/torch_kernels/``, one compiler per source, with ptxas's lines;
3. kernels: each kernel wrapper against its plain PyTorch version on the
   card, with the kernel, the plain version and one PyTorch library call
   (where one computes the same function) timed by CUDA events beside the
   least time the card could take:
   - decode_attention at the reference test shapes, the decoder's shape and
     large cache shapes;
   - flash_attention in fp32 at the JAX tests' shapes, block pairs and
     causal settings (the result must not depend on the blocks), in bf16 at
     the JAX chip benchmark's (4, 2048, 8, 128), and at the served
     long_context_encoder shape (1, S, 4, 16) for S = 100, 4096, 8192;
   - quantize_int8 element-exact (exact half-steps, values past the clip)
     and dequantize_int8 exact, at (1, 8192), a ragged length and 64 MiB;
4. server: the port's HTTP server with its model zoo and
   ``long_context_encoder`` on the GPU, driven by the port's client, each
   path with every launch count set to 0 just before it and read just
   after:
   - ``simple`` over the wire; ``identity_fp32`` at 4 MiB and 64 MiB over
     the wire, system shared memory and colocated cuda shared memory;
     ``decoder_lm`` over the sequence API and ``tiny_lm_generate`` over
     ``generate_stream``, checked against a CPU run of the port with the
     same weights (decode_attention launches = tokens x layers);
   - ``long_context_encoder`` (flash, dim 64, heads 4) at S = 100, 4096 and
     8192 over the wire and colocated cuda shared memory, checked against a
     CPU run of the port with the same weights (flash_attention launches =
     requests), with its request p50 by data plane;
   - the int8 wire path of ``examples/quantized_wire_client.py``: quantize
     on the card, INT8 through ``identity_int8``, dequantize, error within
     half a step (one quantize and one dequantize launch per round trip).

It then prints one ``{"kernels": [...]}`` line and, last, one line
``{"ok": true, "device": {...}}``. Details go to ``build/chip_smoke.json``.
Without a CUDA device it fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import client_tpu_torch.http as httpclient  # noqa: E402
import client_tpu_torch.ops.quantize as qz  # noqa: E402
from client_tpu_torch.models import LongContextEncoderModel, default_model_zoo  # noqa: E402
from client_tpu_torch.models.long_context import WEIGHTS, load_jax_params  # noqa: E402
from client_tpu_torch.models.decoder import TinyDecoderModel  # noqa: E402
from client_tpu_torch.models.generate import TinyGenerateModel  # noqa: E402
from client_tpu_torch.ops import _kernels  # noqa: E402
from client_tpu_torch.ops import decode_attention as da  # noqa: E402
# the module's names (ops.flash_attention itself is the function)
from client_tpu_torch.ops.flash_attention import LAUNCHES as FLASH_LAUNCHES  # noqa: E402
from client_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_reference,
)
from client_tpu_torch.server import HttpInferenceServer, ServerCore  # noqa: E402
from client_tpu_torch.utils import cuda_shared_memory as cudashm  # noqa: E402
from client_tpu_torch.utils import numpy_to_tensor  # noqa: E402
from client_tpu_torch.utils import shared_memory as shm  # noqa: E402

# H100 SXM (NVIDIA data sheet): HBM bandwidth and dense peaks, per dtype
# (float32 outside the tensor cores: the port's fp32 kernels use no TF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# kernel against its plain version, per kernel and dtype:
# - decode_attention: max |out - ref| < tol (tests/test_decode_attention.py);
# - flash_attention: |out - ref| <= tol + tol * |ref| elementwise, the JAX
#   tests' atol = rtol (tests/test_utils.py: 2e-5 in fp32); in bf16 2e-2, as
#   the kernel rounds p to bf16 before PV and the output to bf16, where the
#   plain version keeps fp32;
# - quantize_int8 / dequantize_int8: element exact.
TOLERANCE = {
    "decode_attention": {"float32": 1e-5, "bfloat16": 2e-2},
    "flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
    "quantize_int8": 0.0,
    "dequantize_int8": 0.0,
}
# launch counters of the kernel wrappers, by kernel name
COUNTERS = {
    "decode_attention": da.LAUNCHES,
    "flash_attention": FLASH_LAUNCHES,
    "quantize_int8": qz.QUANTIZE_LAUNCHES,
    "dequantize_int8": qz.DEQUANTIZE_LAUNCHES,
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


def build_kernels():
    t0 = time.perf_counter()
    logs = _kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [f"{name}: {line.strip()}" for name, text in logs.items()
             for line in text.splitlines() if "registers" in line or "spill" in line]
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
    # the decoder's own shape at a mid-run position
    cases.append(("decoder", (1, 4, 128, 32), [11], "bfloat16"))
    rows = []
    worst = {}
    for i, (kind, (b, h, m, d), positions, name) in enumerate(cases):
        q, k, v = attention_inputs(b, h, m, d, dtypes[name], seed=i)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        out = da.decode_attention(q, k, v, pos)
        ref = da.decode_attention_reference(q, k, v, pos)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rows.append({"case": kind, "shape": [b, h, m, d], "pos": positions,
                     "dtype": name, "max_abs_err": err, "tol": tol[name]})
        worst[name] = max(worst.get(name, 0.0), err)
        if not err < tol[name] or out.dtype != q.dtype:
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
        "max_abs_err": err,
        "ms": cuda_ms(lambda: da.decode_attention(q, k, v, pos), iters),
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


def flash_agrees(out, ref, tol):
    """(max |out - ref|, every element within tol + tol * |ref|)."""
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), bool((diff <= tol + tol * ref.float().abs()).all())


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
    rows = []
    first = {}
    for kind, shape, name, causal, (bq, bk) in cases:
        q, k, v = flash_inputs(shape, DTYPES[name], seed=shape[1] + causal)
        out = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
        ref = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = TOLERANCE["flash_attention"][name]
        err, ok = flash_agrees(out, ref, tol)
        rows.append({"case": kind, "shape": list(shape), "dtype": name, "causal": causal,
                     "blocks": [bq, bk], "max_abs_err": err, "tol": tol})
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
    """quantize_int8 element-exact and dequantize_int8 exact against their
    plain versions: fp32 and bf16, a power-of-two scale (exact half-steps
    after the multiply) and the example's max/127 scale; the wire shape, a
    ragged length (the kernels' scalar tail) and 64 MiB of fp32."""
    rows = []
    for name, dtype in DTYPES.items():
        for n in (8192, 8195, 16 * MIB):
            for scale_kind in ("pow2", "fit"):
                x = quantize_inputs(n, dtype, 2.0 ** -5, seed=n)
                scale = 2.0 ** -5 if scale_kind == "pow2" else x.float().abs().max().item() / 127
                q = qz.quantize_int8(x, scale)
                q_ref = qz.quantize_int8_reference(x, scale)
                back = qz.dequantize_int8(q, scale, dtype)
                back_ref = qz.dequantize_int8_reference(q, scale, dtype)
                torch.cuda.synchronize()
                row = {"n": n, "dtype": name, "scale": scale,
                       "quantize_mismatches": int((q != q_ref).sum().item()),
                       "dequantize_mismatches": int((back != back_ref).sum().item())}
                rows.append(row)
                if row["quantize_mismatches"] or row["dequantize_mismatches"]:
                    raise AssertionError(f"int8 kernels disagree with their plain versions: {row}")
    # every int8 value, -128 included, through dequantize
    q = torch.arange(-128, 128, dtype=torch.int8, device="cuda").repeat(33)
    for name, dtype in DTYPES.items():
        if not torch.equal(qz.dequantize_int8(q, 0.37, dtype),
                           qz.dequantize_int8_reference(q, 0.37, dtype)):
            raise AssertionError(f"dequantize_int8 {name} differs over the int8 range")
    return rows


def time_quantize(n, iters):
    """Both kernels and their plain versions on n fp32 elements, beside the
    bytes bound; the yardstick for dequantize is ``q * scale`` (no single
    PyTorch call computes quantize's multiply, round, clip and cast)."""
    x = quantize_inputs(n, torch.float32, 0.03, seed=5)
    scale = x.abs().max().item() / 127
    q = qz.quantize_int8(x, scale)
    q_err = (q.int() - qz.quantize_int8_reference(x, scale).int()).abs().max().item()
    d_err = (qz.dequantize_int8(q, scale)
             - qz.dequantize_int8_reference(q, scale)).abs().max().item()
    if q_err or d_err:
        raise AssertionError(f"int8 kernels disagree at n = {n}: {q_err}, {d_err}")
    bound_ms = (4 * n + n) / PEAK_BYTES_PER_S * 1e3  # fp32 in/out, int8 out/in
    return {
        "n": n, "bytes_fp32": 4 * n, "scale": scale,
        "quantize": {
            "ms": cuda_ms(lambda: qz.quantize_int8(x, scale), iters),
            "device_ms": device_ms_per_launch(lambda: qz.quantize_int8(x, scale),
                                              "::quantize_kernel", 20),
            "plain_ms": cuda_ms(lambda: qz.quantize_int8_reference(x, scale), iters),
            "library_ms": None, "bound_ms": bound_ms, "max_abs_err": q_err},
        "dequantize": {
            "ms": cuda_ms(lambda: qz.dequantize_int8(q, scale), iters),
            "device_ms": device_ms_per_launch(lambda: qz.dequantize_int8(q, scale),
                                              "::dequantize_kernel", 20),
            "plain_ms": cuda_ms(lambda: qz.dequantize_int8_reference(q, scale), iters),
            "library_ms": cuda_ms(lambda: q * scale, iters),
            "bound_ms": bound_ms, "max_abs_err": d_err},
    }


def device_ms_per_launch(fn, kernel_name, runs):
    """Device time alone per launch of the kernel named ``kernel_name``
    over ``runs`` calls of ``fn``, from a torch.profiler trace (the CUDA
    event time of back-to-back wrapper calls includes the host's launch
    cost, which dominates at small sizes); None if the trace has none."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    hits = [k for k in device_kernels(prof) if kernel_name in k["name"]]
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


def drive_identity(client, nbytes: int, iters: int):
    """identity_fp32 over the wire, system shm and colocated cuda shm."""
    n = nbytes // 4
    shape = [1, n]
    x = torch.arange(n, dtype=torch.float32, device="cuda").reshape(shape) * 0.5
    x_host = x.cpu().numpy()
    row = {"bytes": nbytes}

    def wire():
        inp = httpclient.InferInput("INPUT0", shape, "FP32").set_data_from_numpy(x_host)
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
            inp = httpclient.InferInput("INPUT0", shape, "FP32").set_shared_memory(f"sin{tag}", nbytes)
            out = httpclient.InferRequestedOutput("OUTPUT0")
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
            inp = httpclient.InferInput("INPUT0", shape, "FP32").set_shared_memory(f"cin{tag}", nbytes)
            out = httpclient.InferRequestedOutput("OUTPUT0")
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
    expected = {
        "decoder": (decoder_counts, {"decode_attention": stepped * layers}),
        "long_context_encoder": (lc_counts, {"flash_attention": lc_requests}),
        "int8 wire": (int8_counts, {"quantize_int8": round_trips, "dequantize_int8": round_trips}),
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
    # after the launch counts were read: where a served request's time goes
    result["profile"] = profile_decode(decoder, prompt, steps)
    result["long_context_profile"] = profile_long_context(encoder, 8192, 5)
    return result, {"decode_attention": launches, "flash_attention": lc_counts["flash_attention"],
                    "quantize_int8": int8_counts["quantize_int8"],
                    "dequantize_int8": int8_counts["dequantize_int8"]}


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


def main() -> int:
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

    rows, worst = check_decode_attention()
    for row in rows:
        log(f"kernel decode_attention {row['case']} {row['shape']} pos {row['pos']} "
            f"{row['dtype']}: max_abs_err {row['max_abs_err']:.3g} (tol {row['tol']})")
    timed = [time_decode_attention((1, 4, 128, 32), [11], 200)]
    for shape, iters in (((8, 8, 2048, 128), 50), ((8, 8, 8192, 128), 20),
                         ((16, 8, 4096, 128), 20)):
        timed.append(time_decode_attention(shape, [shape[2] - 1] * shape[0], iters))
    for row in timed:
        log(f"time decode_attention {row['shape']} pos {row['pos'][0]} bf16: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_ms'] / row['ms']:.1%} of bound)")

    flash_rows = check_flash_attention()
    for row in flash_rows:
        log(f"kernel flash_attention {row['case']} {row['shape']} {row['dtype']} "
            f"causal={row['causal']} blocks {row['blocks']}: max_abs_err "
            f"{row['max_abs_err']:.3g} (atol = rtol = {row['tol']})")
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
        "cases (fp32 and bf16; n = 8192, 8195, 16 Mi; half-steps and clipping) and over "
        "every int8 value")
    quant_timed = [time_quantize(8192, 200), time_quantize(16 * MIB, 20)]
    for row in quant_timed:
        for name in ("quantize", "dequantize"):
            t = row[name]
            library = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            device = "not measured" if t["device_ms"] is None else f"{t['device_ms']:.4f} ms"
            log(f"time {name}_int8 n={row['n']} fp32: kernel {t['ms']:.4f} ms "
                f"({device} on the device), plain "
                f"{t['plain_ms']:.4f} ms, library {library}, bound {t['bound_ms']:.5f} ms "
                f"(bytes; {t['bound_ms'] / t['ms']:.1%} of bound)")

    served, launches = serve_and_check()
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
        "shape": main_row["shape"],
        "pos": main_row["pos"],
        "at_shapes": timed[1:],
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
        "shape": flash_row["shape"],
        "dtype": flash_row["dtype"],
        "at_shapes": flash_timed[1:],
    })
    wire_row = quant_timed[0]
    for name, replaces, note in (
            ("quantize_int8", "client_tpu/ops/__init__.py:170",
             "no single PyTorch call computes multiply, round half to even, clip to "
             "[-127, 127] and cast to int8"),
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
            # device time alone per launch (profiler); "ms" is a wrapper call
            # back to back, host launch cost included
            "device_ms": t["device_ms"],
            "n": wire_row["n"],
            "at_shapes": [{"n": row["n"], **row[name.split("_")[0]]}
                          for row in quant_timed[1:]],
        })
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_seconds": seconds, "ptxas": ptxas,
                   "checks": rows, "worst_err": worst, "timed": timed,
                   "flash_checks": flash_rows, "flash_timed": flash_timed,
                   "quantize_checks": quant_rows, "quantize_timed": quant_timed,
                   "served": served, "kernels": kernels}, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
