#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``client_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: the ``nvidia-smi`` name and power-limit line;
2. build: every kernel under ``client_tpu_torch/csrc`` built from source
   with nvcc into ``build/torch_kernels/``;
3. kernels: each kernel wrapper against its plain PyTorch version on the
   card at the reference test shapes, the decoder's shape and large cache
   shapes, with the kernel, the plain version and one PyTorch library call
   timed by CUDA events beside the least time the card could take;
4. server: the port's HTTP server with its model zoo on the GPU, driven by
   the port's client — ``simple`` over the wire; ``identity_fp32`` at 4 MiB
   and 64 MiB over the wire, system shared memory and colocated cuda shared
   memory; ``decoder_lm`` over the sequence API and ``tiny_lm_generate``
   over ``generate_stream``, checked against a CPU run of the port with the
   same weights, with the kernels' launches counted on this path alone.

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
from client_tpu_torch.models import default_model_zoo  # noqa: E402
from client_tpu_torch.models.decoder import TinyDecoderModel  # noqa: E402
from client_tpu_torch.models.generate import TinyGenerateModel  # noqa: E402
from client_tpu_torch.ops import _kernels  # noqa: E402
from client_tpu_torch.ops import decode_attention as da  # noqa: E402
from client_tpu_torch.server import HttpInferenceServer, ServerCore  # noqa: E402
from client_tpu_torch.utils import cuda_shared_memory as cudashm  # noqa: E402
from client_tpu_torch.utils import shared_memory as shm  # noqa: E402

# H100 SXM (NVIDIA data sheet): HBM bandwidth and dense peaks, per dtype
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_decode_attention.py

MIB = 1 << 20


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
    ptxas = [line.strip() for text in logs.values() for line in text.splitlines()
             if "registers" in line or "spill" in line]
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
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
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
                     "dtype": name, "max_abs_err": err, "tol": TOLERANCE[name]})
        worst[name] = max(worst.get(name, 0.0), err)
        if not err < TOLERANCE[name] or out.dtype != q.dtype:
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
                     "dtype": name, "max_abs_err": err, "tol": TOLERANCE[name]})
        if not err < TOLERANCE[name]:
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
    if not err < TOLERANCE["bfloat16"]:
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
    server = HttpInferenceServer(ServerCore(default_model_zoo("cuda"))).start()
    client = httpclient.InferenceServerClient(server.url, network_timeout=600.0)
    try:
        decoder = server.core.model("decoder_lm")
        layers = decoder.LAYERS
        # one request first, so library set-up (cuBLAS) is not in the timings
        warm = httpclient.InferInput("TOKENS", [1, 1], "INT32")
        warm.set_data_from_numpy(np.array([[1]], dtype=np.int32))
        client.infer("decoder_lm", [warm], sequence_id=16, sequence_start=True,
                     sequence_end=True)
        da.LAUNCHES.reset()

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
        launches = da.LAUNCHES.count
    finally:
        client.close()
        server.stop()

    gen_tokens = [e["NEXT_TOKEN"] for e in events]
    if [e["INDEX"] for e in events] != list(range(max_tokens)):
        raise AssertionError(f"generate_stream indices out of order: {events}")
    # tokens through the decode step: prompt + continuations, and for the
    # stream the prompt + every emitted token but the last
    stepped = (len(prompt) + steps) + (len(prompt) + max_tokens - 1)
    if launches != stepped * layers:
        raise AssertionError(
            f"decode_attention launched {launches} times on the served path, "
            f"expected {stepped} tokens x {layers} layers")

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
    # after the launch count was read: where a served decode step's time goes
    result["profile"] = profile_decode(decoder, prompt, steps)
    return result, launches


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
    kernels = []
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", 0)
        if device_us > 0 and event.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": event.key[:80], "count": event.count,
                            "total_ms": device_us / 1e3})
    kernels.sort(key=lambda k: -k["total_ms"])
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
        f"decode_attention launches {launches} = {dec['tokens_stepped']} tokens x "
        f"{dec['layers']} layers")

    main_row = timed[0]
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/decode_attention.cu",
        "replaces": "client_tpu/ops/decode_attention.py:121",
        "launches": launches,
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
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_seconds": seconds, "ptxas": ptxas,
                   "checks": rows, "worst_err": worst, "timed": timed,
                   "served": served, "kernels": kernels}, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
