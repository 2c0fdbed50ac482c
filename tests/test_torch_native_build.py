"""``client_tpu_torch.native_build``: the host libraries built from source
with ``g++`` at first use (no cmake), one compiler a source, under a file
lock, named by a hash; a missing header named in the error."""

import re
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

import pytest

from client_tpu_torch import native, native_build

REPO = Path(__file__).resolve().parent.parent


def _cmake_target(name):
    """The sources of ``add_library(<name> SHARED ...)`` in native/CMakeLists.txt."""
    text = (REPO / "native" / "CMakeLists.txt").read_text()
    body = re.search(rf"add_library\({name} SHARED(.*?)\)", text, re.S).group(1)
    return body.split()


def test_sources_are_the_cmake_httpclient_target():
    assert [f"src/{name}" for name in native_build.HTTP_SOURCES] == _cmake_target("httpclient")
    assert [p.relative_to(REPO).as_posix() for p in native_build.http_sources()] == [
        f"native/src/{name}" for name in native_build.HTTP_SOURCES
    ] + ["client_tpu_torch/csrc/native_cuda_shm.cc"]
    assert all(p.exists() for p in native_build.http_sources())


def test_curl_header_search_follows_cmake():
    text = (REPO / "native" / "CMakeLists.txt").read_text()
    paths = re.search(r"find_path\(CURL_INCLUDE_DIR curl/curl.h\s+PATHS(.*?)\)", text,
                      re.S).group(1).split()
    assert native_build.curl_include_dirs() == paths and paths[0] == "/usr/include"
    assert native_build.curl_library_dirs() == ["/usr/lib/x86_64-linux-gnu",
                                                "/lib/x86_64-linux-gnu"]


def test_nothing_builds_at_import():
    """Importing the native modules starts no compiler and loads nothing."""
    code = (
        "import subprocess, sys\n"
        "calls = []\n"
        "real = subprocess.Popen.__init__\n"
        "def spy(self, *a, **k):\n"
        "    calls.append(a)\n"
        "    real(self, *a, **k)\n"
        "subprocess.Popen.__init__ = spy\n"
        "import client_tpu_torch.native as native\n"
        "import client_tpu_torch.native_build\n"
        "import client_tpu_torch.server.embed\n"
        "import client_tpu_torch.perf\n"
        "print(len(calls), native._lib is None)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["0", "True"]


def test_probe_reports_every_need():
    found = native_build.probe()
    assert set(found) == {name for needs in native_build.NEEDS.values() for name in needs}
    for name, where in found.items():
        assert where is None or Path(where).exists(), (name, where)


@pytest.mark.parametrize("target, patch, named", [
    ("http", "curl", "curl/curl.h"),
    ("http", "zlib", "zlib.h"),
    ("embed", "python", "Python.h"),
    ("embed_host", "python", "Python.h"),
])
def test_a_missing_header_is_named(monkeypatch, tmp_path, target, patch, named):
    if patch == "curl":
        monkeypatch.setattr(native_build, "curl_include_dirs", lambda: [str(tmp_path)])
    elif patch == "zlib":
        monkeypatch.setattr(native_build, "ZLIB_INCLUDE_DIRS", (str(tmp_path),))
    else:
        paths = dict(sysconfig.get_paths(), include=str(tmp_path))
        monkeypatch.setattr(native_build.sysconfig, "get_paths", lambda: paths)
    assert named in native_build.missing(target)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native_build.NativeBuildError, match=re.escape(named)):
        native_build.build_all([target])
    assert not (tmp_path / "build").exists()


def test_load_names_the_missing_header(monkeypatch, tmp_path):
    """``native.load`` raises the client's exception naming what is missing
    (no quiet fallback to another library)."""
    monkeypatch.setattr(native_build, "curl_include_dirs", lambda: [str(tmp_path)])
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.InferenceServerException, match="curl/curl.h"):
        native.load()
    assert not native.available()


def test_parallel_builds_build_once(monkeypatch, tmp_path):
    """Workers asking for the same libraries at once: one compiles each
    target under the file lock, the others wait and find it built."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    records, errors = [], []

    def build():
        try:
            records.append(native_build.build_all(["embed", "embed_host"]))
        except Exception as e:  # asserted below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and len(records) == 3
    for target in ("embed", "embed_host"):
        assert sum(r[target]["built"] for r in records) == 1
        assert len({r[target]["path"] for r in records}) == 1
    lib = Path(records[0]["embed"]["path"])
    assert lib.parent == tmp_path and re.fullmatch(
        r"libclient_tpu_torch_embed\.[0-9a-f]{12}\.so", lib.name)
    assert sorted(p.name for p in tmp_path.iterdir() if not p.name.endswith(".lock")) == sorted(
        [lib.name, Path(records[0]["embed_host"]["path"]).name])


def test_the_name_follows_the_sources(monkeypatch, tmp_path):
    """A changed source is a new library name (no stale library is loaded)."""
    before = native_build.embed_library_path()
    shim = tmp_path / "server_embed.cc"
    shim.write_bytes((native_build.CSRC / "server_embed.cc").read_bytes() + b"\n// changed\n")
    monkeypatch.setattr(native_build, "CSRC", tmp_path)
    assert native_build.embed_library_path() != before


def test_host_env_points_at_this_interpreter(monkeypatch):
    monkeypatch.setenv("PYTHONHOME", "/nowhere")
    env = native_build.host_env()
    assert "PYTHONHOME" not in env
    assert env["PYTHONPATH"]
