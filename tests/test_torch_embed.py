"""``client_tpu_torch.server.embed`` (the Python half of the embedded
server) against ``client_tpu.server.embed`` on the same request bodies, and
the port's plain C host (``csrc/embed_host.c``) built and run on the CPU."""

import json
import subprocess

import numpy as np
import pytest
import torch

from client_tpu.server import embed as jax_embed
from client_tpu_torch import native_build
from client_tpu_torch.server import embed
from test_torch_decoder_batched import _near_ties
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

REPO = native_build.REPO
PORT_OPTIONS = {"models": ["simple", "decoder_lm"], "device": "cpu"}
JAX_OPTIONS = {"models": ["simple", "decoder_lm"]}
PROMPT, STEPS = [1, 2, 3, 4], 8
LOGIT_ATOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def handles():
    """{package: handle} of a server of simple and decoder_lm in each."""
    made = {"port": embed.create(json.dumps(PORT_OPTIONS)),
            "jax": jax_embed.create(json.dumps(JAX_OPTIONS))}
    yield made
    embed.destroy(made["port"])
    jax_embed.destroy(made["jax"])


MODULES = {"port": embed, "jax": jax_embed}


def _simple_body(binary):
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.ones((1, 16), dtype=np.int32)
    if not binary:
        body = json.dumps({"inputs": [
            {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
             "data": a.reshape(-1).tolist()},
            {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16],
             "data": b.reshape(-1).tolist()}]}).encode()
        return body, -1, a, b
    header = json.dumps({
        "inputs": [{"name": n, "datatype": "INT32", "shape": [1, 16],
                    "parameters": {"binary_data_size": 64}} for n in ("INPUT0", "INPUT1")],
        "outputs": [{"name": n, "parameters": {"binary_data": True}}
                    for n in ("OUTPUT0", "OUTPUT1")]}).encode()
    return header + a.tobytes() + b.tobytes(), len(header), a, b


def _decoder_body(tokens, start, end):
    header = json.dumps({
        "parameters": {"sequence_id": 5, "sequence_start": start, "sequence_end": end},
        "inputs": [{"name": "TOKENS", "datatype": "INT32", "shape": [1, len(tokens)],
                    "parameters": {"binary_data_size": 4 * len(tokens)}}],
        "outputs": [{"name": n, "parameters": {"binary_data": True}}
                    for n in ("LOGITS", "NEXT_TOKEN")]}).encode()
    return header + np.asarray(tokens, np.int32).tobytes(), len(header)


def _tails(body, header_length):
    header = json.loads(body[:header_length])
    out, at = {}, header_length
    for entry in header["outputs"]:
        size = entry["parameters"]["binary_data_size"]
        out[entry["name"]] = body[at:at + size]
        at += size
    return out


def test_create_infer_metadata_statistics_destroy():
    """create -> infer (two-part body) -> metadata -> statistics -> destroy,
    no HTTP, on the CPU."""
    handle = embed.create(json.dumps({"models": ["simple"], "device": "cpu"}))
    try:
        body, header_length, a, b = _simple_body(True)
        out, response_header = embed.infer(handle, "simple", "", body, header_length)
        assert response_header > 0 and len(out) == response_header + 128
        tails = _tails(out, response_header)
        np.testing.assert_array_equal(np.frombuffer(tails["OUTPUT0"], np.int32), (a + b)[0])
        np.testing.assert_array_equal(np.frombuffer(tails["OUTPUT1"], np.int32), (a - b)[0])
        meta = json.loads(embed.metadata_json(handle, "simple"))
        assert {i["name"] for i in meta["inputs"]} == {"INPUT0", "INPUT1"}
        assert json.loads(embed.metadata_json(handle))["name"]
        stats = json.loads(embed.statistics_json(handle))
        assert stats["model_stats"][0]["name"] == "simple"
        assert stats["model_stats"][0]["inference_stats"]["success"]["count"] == 1
        assert [m["name"] for m in json.loads(embed.repository_index_json(handle))] == ["simple"]
        assert embed._selftest() == "ok"
    finally:
        embed.destroy(handle)
    embed.destroy(handle)  # a second destroy is a no-op


def test_create_defaults_to_the_card():
    """No "device" in the options: the zoo is built for "cuda" (here, where
    there is no card, building it fails rather than falling back)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(Exception):
        handle = embed.create(json.dumps({"models": ["simple"]}))
        try:
            body, header_length, _, _ = _simple_body(True)
            embed.infer(handle, "simple", "", body, header_length)
        finally:
            embed.destroy(handle)


def test_errors_as_jax():
    """An unknown model at create, an unknown model at infer and a destroyed
    handle: the same exception types' names and messages as JAX's."""
    got = {}
    for package, module in MODULES.items():
        errors = []
        opts = {"models": ["no_such_model"]}
        if package == "port":
            opts["device"] = "cpu"
        with pytest.raises(ValueError) as err:
            module.create(json.dumps(opts))
        errors.append(str(err.value))
        handle = module.create(json.dumps({"models": ["simple"], "device": "cpu"}
                                          if package == "port" else {"models": ["simple"]}))
        with pytest.raises(Exception) as err:
            module.infer(handle, "missing", "", b"{}", -1)
        errors.append((type(err.value).__name__, str(err.value)))
        module.destroy(handle)
        with pytest.raises(ValueError) as err:
            module.infer(handle, "simple", "", b"{}", -1)
        errors.append(str(err.value).replace(str(handle), "N"))
        got[package] = errors
    assert got["port"] == got["jax"]
    assert "unknown models" in got["port"][0] and got["port"][2] == "invalid server handle N"


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "json"])
def test_simple_body_byte_identical_to_jax(handles, binary):
    body, header_length, _, _ = _simple_body(binary)
    got = {package: module.infer(handles[package], "simple", "", body, header_length)
           for package, module in MODULES.items()}
    assert got["port"] == got["jax"]
    assert (got["port"][1] == -1) == (not binary)


def test_admin_documents_as_jax(handles):
    """Model metadata (but its platform) and the repository index equal
    JAX's; statistics have JAX's keys and count the same requests."""
    body, header_length, _, _ = _simple_body(True)
    docs = {}
    for package, module in MODULES.items():
        handle = handles[package]
        module.infer(handle, "simple", "", body, header_length)
        stats = json.loads(module.statistics_json(handle, "simple"))["model_stats"][0]
        docs[package] = {
            "metadata": json.loads(module.metadata_json(handle, "simple")),
            "index": json.loads(module.repository_index_json(handle)),
            "stat_keys": sorted(stats), "success": stats["inference_stats"]["success"]["count"],
        }
    # the platform names the framework (pytorch here, jax there)
    assert {p: docs[p]["metadata"].pop("platform") for p in docs} == {"port": "pytorch",
                                                                     "jax": "jax"}
    assert docs["port"] == docs["jax"]
    assert docs["port"]["success"] == 1


def test_decoder_lm_against_jax(handles):
    """The prompt and 8 greedy steps through both packages' embedded
    ``decoder_lm``, each step fed JAX's token: logits within 5e-2 and the
    tokens equal but at a near tie (``test_torch_decoder_batched``'s rule)."""
    rows = {"port": [], "jax": []}
    tokens, start = list(PROMPT), True
    for step in range(STEPS + 1):
        end = step == STEPS
        for package, module in MODULES.items():
            tails = _tails(*module.infer(handles[package], "decoder_lm", "",
                                         *_decoder_body(tokens, start, end)))
            logits = np.frombuffer(tails["LOGITS"], np.float32)
            rows[package].append((step, logits, int(np.frombuffer(tails["NEXT_TOKEN"],
                                                                   np.int32)[0])))
        tokens, start = [rows["jax"][-1][2]], False
    for ours, theirs in zip(rows["port"], rows["jax"]):
        assert np.abs(ours[1] - theirs[1]).max() < LOGIT_ATOL
    assert _near_ties({"seq": rows["port"]}, {"seq": rows["jax"]}) == []
    stats = json.loads(embed.statistics_json(handles["port"], "decoder_lm"))["model_stats"][0]
    assert stats["inference_stats"]["success"]["count"] == STEPS + 1


def test_lifecycle_and_http_frontend(handles):
    """unload / load through the embed API, then the core served over HTTP
    by start_http and driven by the port's client."""
    import client_tpu_torch.http as httpclient

    handle = handles["port"]
    embed.unload_model(handle, "simple")
    body, header_length, a, b = _simple_body(True)
    with pytest.raises(Exception):
        embed.infer(handle, "simple", "", body, header_length)
    embed.load_model(handle, "simple")
    port = embed.start_http(handle)
    assert embed.start_http(handle) == port  # one frontend a server
    client = httpclient.InferenceServerClient(f"127.0.0.1:{port}")
    try:
        inputs = [httpclient.InferInput(n, [1, 16], "INT32").set_data_from_numpy(v)
                  for n, v in (("INPUT0", a), ("INPUT1", b))]
        np.testing.assert_array_equal(client.infer("simple", inputs).as_numpy("OUTPUT0"), a + b)
    finally:
        client.close()


def test_embed_host_on_the_cpu(handles):
    """The C host built from source and run as a child on the CPU: exit 0,
    ``simple`` checked, and the decoder's tokens and LOGITS bytes equal to
    the same sequence through the Python half in this process."""
    path = native_build.build_all(["embed_host"])["embed_host"]["path"]
    done = subprocess.run(
        [path, str(REPO), json.dumps(PORT_OPTIONS), str(STEPS), *map(str, PROMPT)],
        cwd=REPO, env=native_build.host_env(), capture_output=True, text=True, timeout=50)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-3000:]
    assert "ok simple" in done.stdout and "PASS embed_host" in done.stdout
    assert "ok typed error on unknown model" in done.stdout
    steps = [line.split() for line in done.stdout.splitlines() if line.startswith("step ")]
    host_tokens = [int(s[3]) for s in steps]
    host_logits = [bytes.fromhex(s[5]) for s in steps]

    tokens, start, want_tokens, want_logits = list(PROMPT), True, [], []
    for step in range(STEPS + 1):
        tails = _tails(*embed.infer(handles["port"], "decoder_lm", "",
                                    *_decoder_body(tokens, start, step == STEPS)))
        want_logits.append(tails["LOGITS"])
        want_tokens.append(int(np.frombuffer(tails["NEXT_TOKEN"], np.int32)[0]))
        tokens, start = [want_tokens[-1]], False
    assert host_tokens == want_tokens and host_logits == want_logits
    stats_line = next(x for x in done.stdout.splitlines() if x.startswith("statistics "))
    counts = {m["name"]: m["inference_stats"]["success"]["count"]
              for m in json.loads(stats_line.split(" ", 1)[1])["model_stats"]}
    assert counts == {"simple": 1, "decoder_lm": STEPS + 1}
