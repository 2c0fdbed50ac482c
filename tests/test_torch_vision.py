"""The port's vision path against the JAX package's.

- ``DenseNetModel`` with the JAX model's own weights (the flax params
  exported to numpy, loaded through ``load_jax_params``) against
  ``client_tpu``'s model on the same image: logits within atol 2e-2 (the
  bound JAX holds its own sharded and single-device runs to; bf16 rounds at
  other places in the two frameworks) and the same argmax, at width 8 with
  16 classes at 224 and at two odd sizes (flax's asymmetric SAME padding),
  and at the served width 96 with 1000 classes.
- ``preprocess`` and the ensemble: the same outputs, config and errors.
- The port's HTTP server serving ``build_image_ensemble`` to the port's
  client and to ``client_tpu.http`` over the wire, and to the port's client
  over colocated cuda shared memory (on the CPU device here), with the
  classification extension: the same top-1 as the JAX server's response
  for the same weights.
"""

import uuid
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import client_tpu.http as jax_http
import client_tpu_torch.http as port_http
from client_tpu.models import build_image_ensemble as jax_build_image_ensemble
from client_tpu.models import vision as jax_vision
from client_tpu.models.ensemble import EnsembleModel as JaxEnsemble
from client_tpu.models.ensemble import EnsembleStep as JaxStep
from client_tpu.models.vision import DenseNetModel as JaxDenseNet
from client_tpu.models.vision import ImagePreprocessModel as JaxPreprocess
from client_tpu.models.vision import _build_flax_model
from client_tpu.server import HttpInferenceServer as JaxServer
from client_tpu.server import ServerCore as JaxCore
from client_tpu_torch.models import (
    DenseNetModel,
    EnsembleModel,
    EnsembleStep,
    ImagePreprocessModel,
    TensorSpec,
    build_image_ensemble,
    default_model_zoo,
)
from client_tpu_torch.models.vision import draw_params, flops_per_image, load_jax_params
from client_tpu_torch.ops import _kernels
from client_tpu_torch.ops import normalize as normalize_module
from client_tpu_torch.server import HttpInferenceServer, ServerCore
from client_tpu_torch.utils import cuda_shared_memory as cudashm

ATOL = 2e-2
WIDTH, CLASSES = 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this file from
    crowding the CPUs of tests running beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_densenet_model(classes, width, seed=0):
    """client_tpu's DenseNetModel with its own weights and its own forward,
    built faster: its ``_ensure_built`` runs as it is, with only the flax
    init traced under jit instead of run op by op at 224 (tens of seconds
    on the tests' 8-device CPU mesh); the params are the same."""

    def build_with_jitted_init(*args):
        module = _build_flax_model(*args)
        object.__setattr__(module, "init", jax.jit(module.init))
        return module

    model = JaxDenseNet(num_classes=classes, width=width, seed=seed)
    with mock.patch.object(jax_vision, "_build_flax_model", build_with_jitted_init):
        model.forward_fn()
    return model


def jax_params(model):
    """The JAX model's flax params as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, model.forward_fn()[1])


def port_with_jax_weights(jax_model, classes, width, **kwargs):
    port = DenseNetModel(num_classes=classes, width=width, device="cpu", **kwargs)
    load_jax_params(port, jax_params(jax_model))
    return port


@pytest.fixture(scope="module")
def jax_densenet():
    return jax_densenet_model(CLASSES, WIDTH)


@pytest.fixture(scope="module")
def port_densenet(jax_densenet):
    return port_with_jax_weights(jax_densenet, CLASSES, WIDTH)


def _chw(size, seed):
    return np.random.default_rng(seed).standard_normal((3, size, size)).astype(np.float32)


def _logits(model, image):
    out = model.execute({"data_0": image}, {})["fc6_1"]
    return (out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)).reshape(-1)


@pytest.mark.parametrize("size", [224, 67, 100])
def test_densenet_matches_jax(jax_densenet, port_densenet, size):
    image = _chw(size, seed=size)
    got, want = _logits(port_densenet, image), _logits(jax_densenet, image)
    assert got.dtype == np.float32 and got.shape == (CLASSES,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got.argmax() == want.argmax()


def test_densenet_at_the_served_width_matches_jax():
    jax_model = jax_densenet_model(1000, 96)
    port = port_with_jax_weights(jax_model, 1000, 96)
    image = _chw(224, seed=3)
    got, want = _logits(port, image), _logits(jax_model, image)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got.argmax() == want.argmax()


@pytest.mark.parametrize("arch", ["lite", "121"])
def test_draw_params_has_the_flax_tree(arch):
    """Names, nesting and shapes of the port's draw equal flax's own init
    (traced for its shapes only)."""
    stages = DenseNetModel.ARCHS[arch]
    module = _build_flax_model(CLASSES, WIDTH, stages)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3), jnp.bfloat16))
    ours = draw_params(CLASSES, WIDTH, stages, seed=0)
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), np.dtype(s.dtype)), shapes)
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), ours)
    assert got == want


def test_draw_params_is_seeded():
    a, b, c = (draw_params(CLASSES, WIDTH, seed=s)["params"] for s in (0, 0, 1))
    np.testing.assert_array_equal(a["Conv_0"]["kernel"], b["Conv_0"]["kernel"])
    assert not np.array_equal(a["Conv_0"]["kernel"], c["Conv_0"]["kernel"])
    # lecun scale: variance 1 / fan_in (7 * 7 * 3 for the stem)
    assert 0.8 < float(np.var(a["Conv_0"]["kernel"])) * 147 < 1.25
    assert not a["Dense_0"]["bias"].any()
    assert (a["ConvBlock_0"]["GroupNorm_0"]["scale"] == 1).all()


def test_own_weights_match_jax_with_the_same_tree(jax_densenet):
    """The port's seeded default and the JAX model given the same tree."""
    port = DenseNetModel(num_classes=CLASSES, width=WIDTH, seed=5, device="cpu")
    fn, _ = jax_densenet.forward_fn()
    tree = jax.tree_util.tree_map(jnp.asarray, draw_params(CLASSES, WIDTH, seed=5))
    image = _chw(224, seed=8)
    want = np.asarray(fn(tree, image[None])).reshape(-1)
    got = _logits(port, image)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got.argmax() == want.argmax()


@pytest.mark.parametrize("change", ["shape", "dtype", "missing"])
def test_load_jax_params_checks_its_arrays(change):
    model = DenseNetModel(num_classes=CLASSES, width=WIDTH, device="cpu")
    params = draw_params(CLASSES, WIDTH)
    block = params["params"]["DenseStage_1"]["ConvBlock_0"]
    if change == "shape":
        block["Conv_0"]["kernel"] = block["Conv_0"]["kernel"][:, :, :2]
    elif change == "dtype":
        block["GroupNorm_0"]["scale"] = block["GroupNorm_0"]["scale"].astype(np.float64)
    else:
        del params["params"]["Dense_0"]
    with pytest.raises(KeyError if change == "missing" else ValueError):
        load_jax_params(model, params)


def test_densenet_metadata_config_and_labels(port_densenet, jax_densenet):
    md, want = port_densenet.metadata(), jax_densenet.metadata()
    assert md["name"] == want["name"] == "densenet_onnx"
    assert md["inputs"] == want["inputs"] == [
        {"name": "data_0", "datatype": "FP32", "shape": [3, 224, 224]}]
    assert md["outputs"] == want["outputs"]
    cfg = port_densenet.config()
    assert cfg["max_batch_size"] == 0 == jax_densenet.config()["max_batch_size"]
    assert cfg["input"] == jax_densenet.config()["input"]
    assert port_densenet.labels() == jax_densenet.labels()
    assert port_densenet.labels()[:2] == ["class_0", "class_1"]


def test_densenet_121_builds_and_runs():
    model = DenseNetModel(num_classes=CLASSES, width=WIDTH, arch="121", device="cpu")
    assert [len(s.blocks) for s in model.net.dense] == [6, 12, 24, 16]
    out = model.execute({"data_0": _chw(64, seed=1)}, {})["fc6_1"]
    assert out.shape == (CLASSES, 1, 1) and torch.isfinite(out).all()


def test_bad_arch_raises():
    with pytest.raises(ValueError, match="arch"):
        DenseNetModel(arch="resnet", device="cpu")


def test_tensor_parallel_raises():
    """``tensor_parallel=4``, which raised until ``parallel/`` was ported,
    now splits the channels over a (1, 4) mesh of CPU shards: logits within
    JAX's own bound (2e-2, tests/test_models_parallel.py) of tp = 1 with the
    same weights and the same top-1; the ensemble builds the same."""
    single = DenseNetModel(num_classes=CLASSES, width=WIDTH, seed=7, device="cpu")
    sharded = DenseNetModel(num_classes=CLASSES, width=WIDTH, seed=7, tensor_parallel=4,
                            device="cpu")
    assert sharded.tp_degree == 4 and sharded.net.stem_shards is not None
    image = np.random.default_rng(3).standard_normal((3, 224, 224)).astype(np.float32)
    want = single.execute({"data_0": image}, {})["fc6_1"].numpy()
    got = sharded.execute({"data_0": image}, {})["fc6_1"].numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert got.argmax() == want.argmax()
    members = build_image_ensemble(num_classes=CLASSES, width=WIDTH, tensor_parallel=4,
                                   device="cpu")
    assert members[1].tp_degree == 4


def test_execute_is_deterministic_and_keeps_a_tensor(port_densenet):
    image = _chw(224, seed=1)
    a = port_densenet.execute({"data_0": image}, {})["fc6_1"]
    b = port_densenet.execute({"data_0": torch.from_numpy(image)}, {})["fc6_1"]
    assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
    assert torch.equal(a, b)


def test_flops_per_image():
    # hand count for width 96 / 1000 classes at 224 (the served model)
    assert flops_per_image(1000, 96, (2, 2, 2)) == 8_158_181_376
    assert flops_per_image(CLASSES, WIDTH, (2, 2, 2)) < flops_per_image(CLASSES, WIDTH,
                                                                        (6, 12, 24, 16))


# -- preprocess and the ensemble ---------------------------------------------


@pytest.mark.parametrize("size", [(300, 400), (224, 224), (99, 61)])
def test_preprocess_model_matches_jax(size):
    img = np.random.default_rng(size[0]).integers(0, 256, size + (3,)).astype(np.uint8)
    got = ImagePreprocessModel(device="cpu").execute({"raw_image": img}, {})["preprocessed"]
    want = JaxPreprocess().execute({"raw_image": img}, {})["preprocessed"]
    assert isinstance(got, torch.Tensor) and got.shape == (3, 224, 224)
    np.testing.assert_array_equal(got.numpy(), want)
    ours, ref = ImagePreprocessModel(device="cpu").metadata(), JaxPreprocess().metadata()
    assert {k: ours[k] for k in ("name", "inputs", "outputs")} == {
        k: ref[k] for k in ("name", "inputs", "outputs")}


def test_ensemble_config_matches_jax():
    port = {m.name: m for m in build_image_ensemble(CLASSES, WIDTH, device="cpu")}
    ref = {m.name: m for m in jax_build_image_ensemble(CLASSES, WIDTH)}
    assert list(port) == list(ref) == ["preprocess", "densenet_onnx", "ensemble_image"]
    cfg, want = port["ensemble_image"].config(), ref["ensemble_image"].config()
    assert cfg["platform"] == "ensemble"
    assert cfg["ensemble_scheduling"] == want["ensemble_scheduling"]
    assert cfg["ensemble_scheduling"]["step"][1]["input_map"] == {"data_0": "stage0"}
    assert port["ensemble_image"].metadata() == ref["ensemble_image"].metadata()


def _broken(package, kind):
    """(ensemble, registry) built with ``package``'s classes that fail the
    ``kind`` way."""
    ensemble_cls, step_cls, spec_cls, preprocess = package
    img = [spec_cls("IMAGE", "UINT8", [-1, -1, 3])]
    out = [spec_cls("OUT", "FP32", [3, 224, 224])]
    steps = {
        "unbound": [step_cls("preprocess", {"IMAGE": "raw_image"}, {"preprocessed": "OUT"})],
        "missing_tensor": [step_cls("preprocess", {"NOPE": "raw_image"},
                                    {"preprocessed": "OUT"})],
        "missing_output": [step_cls("preprocess", {"IMAGE": "raw_image"},
                                    {"nothing": "OUT"})],
    }[kind]
    ensemble = ensemble_cls("broken", steps, img, out)
    if kind != "unbound":
        ensemble.bind({"preprocess": preprocess}.__getitem__)
    return ensemble


@pytest.mark.parametrize("kind", ["unbound", "missing_tensor", "missing_output"])
def test_ensemble_errors_match_jax(kind):
    img = np.zeros((8, 8, 3), np.uint8)
    port = _broken((EnsembleModel, EnsembleStep, TensorSpec, ImagePreprocessModel(device="cpu")),
                   kind)
    from client_tpu.models.base import TensorSpec as JaxSpec

    ref = _broken((JaxEnsemble, JaxStep, JaxSpec, JaxPreprocess()), kind)
    errors = []
    for model in (port, ref):
        with pytest.raises((RuntimeError, ValueError)) as info:
            model.execute({"IMAGE": img}, {})
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_ensemble_hands_device_tensors_between_stages():
    models = build_image_ensemble(CLASSES, WIDTH, device="cpu")
    core = ServerCore(models, device="cpu")
    seen = {}
    densenet = core.model("densenet_onnx")
    original = densenet.execute

    def spy(inputs, parameters):
        seen["data_0"] = inputs["data_0"]
        return original(inputs, parameters)

    densenet.execute = spy
    img = np.random.default_rng(0).integers(0, 256, (30, 40, 3)).astype(np.uint8)
    out = core.model("ensemble_image").execute({"IMAGE": img}, {})["CLASSIFICATION"]
    assert isinstance(seen["data_0"], torch.Tensor) and seen["data_0"].shape == (3, 224, 224)
    assert isinstance(out, torch.Tensor) and out.shape == (CLASSES, 1, 1)
    assert core.model("ensemble_image").labels() == densenet.labels()


def test_not_in_the_default_zoo():
    names = {m.name for m in default_model_zoo("cpu")}
    assert not names & {"preprocess", "densenet_onnx", "ensemble_image"}


# -- served ------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_models(jax_densenet):
    models = build_image_ensemble(CLASSES, WIDTH, device="cpu")
    load_jax_params(models[1], jax_params(jax_densenet))
    return models


@pytest.fixture(scope="module")
def port_server(served_models):
    server = HttpInferenceServer(ServerCore(served_models, device="cpu")).start()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def jax_server(jax_densenet):
    # the JAX ensemble with the very model (and weights) the port loaded
    preprocess, _, ensemble = jax_build_image_ensemble(CLASSES, WIDTH)
    with JaxServer(JaxCore([preprocess, jax_densenet, ensemble])) as server:
        yield server


def _top(http, url, model, name, inp_name, shape, datatype, data, k=3):
    client = http.InferenceServerClient(url)
    try:
        inp = http.InferInput(inp_name, shape, datatype).set_data_from_numpy(data)
        out = http.InferRequestedOutput(name, class_count=k)
        entries = client.infer(model, [inp], outputs=[out]).as_numpy(name).reshape(-1)
    finally:
        client.close()
    return [entry.decode().split(":") for entry in entries]


REQUESTS = {
    "densenet_onnx": ("fc6_1", "data_0", [3, 224, 224], "FP32",
                      lambda: _chw(224, seed=11)),
    "ensemble_image": ("CLASSIFICATION", "IMAGE", [300, 400, 3], "UINT8",
                       lambda: np.random.default_rng(0).integers(0, 256, (300, 400, 3))
                       .astype(np.uint8)),
}


@pytest.mark.parametrize("model", list(REQUESTS))
@pytest.mark.parametrize("http", [port_http, jax_http], ids=["port_client", "jax_client"])
def test_served_classification(port_server, jax_server, http, model):
    name, inp_name, shape, datatype, make = REQUESTS[model]
    data = make()
    got = _top(http, port_server.url, model, name, inp_name, shape, datatype, data)
    want = _top(jax_http, jax_server.url, model, name, inp_name, shape, datatype, data)
    assert len(got) == 3 and all(len(e) == 3 for e in got)
    assert [e[2] for e in got] == [f"class_{e[1]}" for e in got]
    assert got[0][1] == want[0][1]  # top-1 index
    np.testing.assert_allclose(float(got[0][0]), float(want[0][0]), atol=ATOL)


@pytest.mark.parametrize("http", [port_http, jax_http], ids=["port_client", "jax_client"])
def test_served_logits(port_server, jax_densenet, http):
    image = _chw(224, seed=12)
    client = http.InferenceServerClient(port_server.url)
    try:
        inp = http.InferInput("data_0", [3, 224, 224], "FP32").set_data_from_numpy(image)
        out = client.infer("densenet_onnx", [inp]).as_numpy("fc6_1")
    finally:
        client.close()
    assert out.dtype == np.float32 and out.shape == (CLASSES, 1, 1)
    np.testing.assert_allclose(out.reshape(-1), _logits(jax_densenet, image), atol=ATOL)


def test_served_over_colocated_cuda_shm(port_server, served_models, jax_densenet):
    """data_0 reaches the model as the client's own tensor; fc6_1 is pinned
    in the output region and never mirrored to the host."""
    image = torch.from_numpy(_chw(224, seed=13))
    in_bytes, out_bytes = image.numel() * 4, CLASSES * 4
    names = [f"dn_{tag}_{uuid.uuid4().hex[:12]}" for tag in ("in", "out")]
    regions = [cudashm.create_shared_memory_region(n, size, device="cpu", colocated=True)
               for n, size in zip(names, (in_bytes, out_bytes))]
    client = port_http.InferenceServerClient(port_server.url)
    try:
        cudashm.set_shared_memory_region_from_torch(regions[0], image)
        for name, region, size in zip(names, regions, (in_bytes, out_bytes)):
            client.register_cuda_shared_memory(name, cudashm.get_raw_handle(region), 0, size)
        inp = port_http.InferInput("data_0", [3, 224, 224], "FP32").set_shared_memory(
            names[0], in_bytes)
        out = port_http.InferRequestedOutput("fc6_1")
        out.set_shared_memory(names[1], out_bytes)
        client.infer("densenet_onnx", [inp], outputs=[out])
        logits = cudashm.get_contents_as_torch(regions[1], "FP32", [CLASSES, 1, 1])
        want = _logits(served_models[1], image.numpy())
        np.testing.assert_array_equal(logits.reshape(-1).numpy(), want)
        jax_want = _logits(jax_densenet, image.numpy())
        np.testing.assert_allclose(want, jax_want, atol=ATOL)
        assert want.argmax() == jax_want.argmax()
        for region in regions:
            assert not np.frombuffer(region.host_buffer(), dtype=np.uint8).any()
        # classification over the region's input
        top = port_http.InferRequestedOutput("fc6_1", class_count=3)
        entries = client.infer("densenet_onnx", [inp], outputs=[top]).as_numpy("fc6_1")
        assert int(entries[0].decode().split(":")[1]) == int(want.argmax())
    finally:
        client.unregister_cuda_shared_memory()
        client.close()
        for region in regions:
            cudashm.destroy_shared_memory_region(region)


def test_cpu_served_path_launches_nothing(port_server):
    before = normalize_module.LAUNCHES.count
    img = np.random.default_rng(1).integers(0, 256, (40, 30, 3)).astype(np.uint8)
    _top(port_http, port_server.url, "ensemble_image", "CLASSIFICATION", "IMAGE",
         [40, 30, 3], "UINT8", img, k=1)
    assert normalize_module.LAUNCHES.count == before
    assert not {"normalize_image", "softmax"} & set(_kernels.loaded())
