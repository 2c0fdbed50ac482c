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
