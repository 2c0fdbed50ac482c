"""``chip_smoke.py``'s resilience and observability phase (phase 6) on the CPU.

The phase serves the default zoo and the vision models behind the port's
``ChaosProxy`` and checks itself: zero errors for the idempotent flows under
faults, a sequence request never re-sent, one ``StreamReconnected`` naming
the abandoned sequence id, the breaker's transitions, the flight recorder's
retained failures, every span joined to a server access record, ``/metrics``
equal to the statistics and the data-plane counters equal to the ops made.
On a CPU device the kernel wrappers run their plain versions and launch
nothing, so its launch gate expects zeros there; the references are a CPU
run of the decoder and of densenet with the seed-0 weights, as on the card.
"""

import numpy as np
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
