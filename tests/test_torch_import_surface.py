"""The port's import surface against the JAX package's, for the paths a
``tritonclient`` user imports: the auth plugins of every client, the HTTP
namespace's ``InferAsyncRequest``, the GRPC namespace's ``proto_path()`` and
the system shm module's ``region_inventory()``.

Each case names the same module or function in both packages and holds
the port's to the JAX one: the same exported names, the same proto bytes,
the same inventory rows for the same region.
"""

import importlib
import tomllib
import uuid
from pathlib import Path

import pytest

import client_tpu.grpc as jax_grpc
import client_tpu.http as jax_http
import client_tpu_torch.grpc as port_grpc
import client_tpu_torch.http as port_http
from client_tpu.utils import shared_memory as jax_shm
from client_tpu_torch.utils import shared_memory as port_shm
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

REPO = Path(__file__).resolve().parent.parent
AUTH = ["http.auth", "http.aio.auth", "grpc.auth", "grpc.aio.auth"]


@pytest.mark.parametrize("path", AUTH)
def test_auth_modules_export_what_the_jax_ones_do(path):
    port = importlib.import_module(f"client_tpu_torch.{path}")
    jax = importlib.import_module(f"client_tpu.{path}")
    assert port.__all__ == jax.__all__ == ["BasicAuth", "InferenceServerClientPlugin"]
    from client_tpu_torch import _base

    assert port.BasicAuth is _base.BasicAuth
    assert port.InferenceServerClientPlugin is _base.InferenceServerClientPlugin


@pytest.mark.parametrize("path", AUTH)
def test_auth_plugin_sets_the_header_as_the_jax_one(path):
    port = importlib.import_module(f"client_tpu_torch.{path}")
    jax = importlib.import_module(f"client_tpu.{path}")
    headers = []
    for mod in (port, jax):
        request = type("Request", (), {"headers": {}})()
        mod.BasicAuth("user", "pa:ss")(request)
        headers.append(request.headers)
    assert headers[0] == headers[1] and headers[0]


@pytest.mark.parametrize("port,jax", [(port_http, jax_http), (port_grpc, jax_grpc)],
                         ids=["http", "grpc"])
def test_namespaces_export_the_jax_names(port, jax):
    assert sorted(port.__all__) == sorted(jax.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_infer_async_request_is_exported():
    from client_tpu_torch.http._client import InferAsyncRequest

    assert port_http.InferAsyncRequest is InferAsyncRequest
    assert "InferAsyncRequest" in port_http.__all__


def test_proto_path_bytes_equal_the_jax_proto():
    path = Path(port_grpc.proto_path())
    assert path.name == Path(jax_grpc.proto_path()).name == "grpc_service.proto"
    assert path.parent == REPO / "client_tpu_torch" / "grpc"
    assert path.read_bytes() == Path(jax_grpc.proto_path()).read_bytes()


def test_packaging_names_the_new_modules():
    config = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]
    for path in AUTH:
        assert f"client_tpu_torch.{path}" in config["packages"]
    assert config["package-data"]["client_tpu_torch.grpc"] == ["grpc_service.proto"]
    assert config["package-data"]["client_tpu.grpc"] == ["grpc_service.proto"]


@pytest.mark.parametrize("size", [64, 4096])
def test_region_inventory_equals_the_jax_one(size):
    key = f"inv_{uuid.uuid4().hex[:12]}"
    rows = []
    for mod in (port_shm, jax_shm):
        region = mod.create_shared_memory_region(key, "/" + key, size)
        try:
            rows.append([r for r in mod.region_inventory() if r["name"] == key])
        finally:
            mod.destroy_shared_memory_region(region)
        assert not [r for r in mod.region_inventory() if r["name"] == key]
    assert rows[0] == rows[1] == [
        {"family": "system", "name": key, "key": "/" + key, "byte_size": size}]
    assert list(rows[0][0]) == list(rows[1][0])  # the keys in the same order
