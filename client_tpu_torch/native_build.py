"""Build the port's host libraries from source, at first use.

Two shared libraries and one program, compiled by ``g++`` / ``gcc`` (no
``cmake``, no ``native/build/``) into ``build/torch_native/`` at the
repository root, each named by a hash of its sources, headers and flags:

- ``libclient_tpu_torch_http.<hash>.so``: the C++ clients of ``native/src``
  (the ten sources of the ``httpclient`` target in ``native/CMakeLists.txt``,
  read unchanged) plus ``csrc/native_cuda_shm.cc``, the port's cuda
  registration entry points; links ``libcurl.so.4``, ``z``, ``rt``,
  ``pthread`` and ``dl``. :mod:`client_tpu_torch.native` binds it.
- ``libclient_tpu_torch_embed.<hash>.so``: ``csrc/server_embed.cc``, the C
  API of ``native/include/client_tpu/server_embed.h`` over an embedded
  interpreter running :mod:`client_tpu_torch.server.embed`; links this
  interpreter's own ``libpython`` (rpath set to its directory).
- ``embed_host.<hash>``: ``csrc/embed_host.c``, a plain C host of the embed
  library.

Each source compiles in a compiler process of its own, all started
together; a file lock beside the target lets parallel workers build it
once. :func:`probe` reports which headers, libraries and compilers are
present; a build that lacks one raises an error naming it. Nothing is built
when this module is imported.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import sysconfig
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

REPO = Path(__file__).resolve().parent.parent
NATIVE = REPO / "native"
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO / "build" / "torch_native"

# the httpclient target of native/CMakeLists.txt, in its order
HTTP_SOURCES = ("base64.cc", "common.cc", "grpc_client.cc", "h2.cc", "http_client.cc",
                "json.cc", "shm_utils.cc", "tls.cc", "tpu_shm.cc", "c_api.cc")
ZLIB_INCLUDE_DIRS = ("/usr/include", "/usr/local/include")

CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC")
C_FLAGS = ("-O2", "-std=c11")
HTTP_LIBS = ("-lrt", "-lpthread", "-ldl")  # beside libcurl and libz, linked by path


class NativeBuildError(RuntimeError):
    """A library could not be built: a header, library or compiler is
    missing (named in the message), or the compiler failed."""


def _cmake_paths(call: str) -> List[str]:
    """The ``PATHS`` of the ``native/CMakeLists.txt`` call that starts with
    ``call``, in its order: curl is looked for where CMake looks for it."""
    text = (NATIVE / "CMakeLists.txt").read_text()
    return re.search(re.escape(call) + r"[^)]*?PATHS([^)]*)\)", text).group(1).split()


def curl_include_dirs() -> List[str]:
    """Where ``curl/curl.h`` is looked for: the system's headers, then the
    copy a tensorflow wheel bundles (CMakeLists' ``find_path``)."""
    return _cmake_paths("find_path(CURL_INCLUDE_DIR")


def curl_library_dirs() -> List[str]:
    """Where ``libcurl`` is looked for (CMakeLists' ``find_library``)."""
    return _cmake_paths("find_library(CURL_LIBRARY")


def _first(dirs: Sequence[str], relative: str) -> Optional[str]:
    for d in dirs:
        if d and os.path.exists(os.path.join(d, relative)):
            return d
    return None


def _curl_library() -> Optional[str]:
    for d in curl_library_dirs():
        for name in ("libcurl.so", "libcurl.so.4"):
            path = os.path.join(d, name)
            if os.path.exists(path):
                return path
    return None


def _python_library() -> Optional[str]:
    """This interpreter's shared ``libpython``: ``LIBDIR/LDLIBRARY``, else
    its versioned soname (``INSTSONAME``) there, else the multiarch
    directory's."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    names = [sysconfig.get_config_var("LDLIBRARY"), sysconfig.get_config_var("INSTSONAME")]
    dirs = [libdir]
    multiarch = sysconfig.get_config_var("MULTIARCH")
    if multiarch:
        dirs.append(os.path.join(libdir, multiarch))
    for d in dirs:
        for name in names:
            if name and ".so" in name:  # not a static libpython.a
                path = os.path.join(d, name)
                if os.path.exists(path):
                    return path
    return None


def probe() -> Dict[str, Optional[str]]:
    """What the builds need and where it was found (``None``: missing):
    the two compilers, ``curl/curl.h``, ``zlib.h``, ``libcurl``, ``libz``,
    ``Python.h`` and ``libpython``."""
    include = sysconfig.get_paths()["include"]
    curl_dir = _first(curl_include_dirs(), "curl/curl.h")
    zlib_dir = _first(ZLIB_INCLUDE_DIRS, "zlib.h")
    lib_dirs = curl_library_dirs() + ["/usr/lib64", "/usr/local/lib"]
    libz = next((os.path.join(d, name) for name in ("libz.so", "libz.so.1")
                 for d in [_first(lib_dirs, name)] if d), None)
    return {
        "g++": shutil.which("g++"),
        "gcc": shutil.which("gcc"),
        "curl/curl.h": os.path.join(curl_dir, "curl/curl.h") if curl_dir else None,
        "zlib.h": os.path.join(zlib_dir, "zlib.h") if zlib_dir else None,
        "libcurl": _curl_library(),
        "libz": libz,
        "Python.h": (os.path.join(include, "Python.h")
                     if os.path.exists(os.path.join(include, "Python.h")) else None),
        "libpython": _python_library(),
    }


# what each build needs of probe()
NEEDS = {
    "http": ("g++", "curl/curl.h", "zlib.h", "libcurl", "libz"),
    "embed": ("g++", "Python.h", "libpython"),
    "embed_host": ("gcc", "Python.h", "libpython"),
}


def missing(target: str, found: Optional[Dict[str, Optional[str]]] = None) -> List[str]:
    """The names in :data:`NEEDS` ``[target]`` that :func:`probe` did not find."""
    found = probe() if found is None else found
    return [name for name in NEEDS[target] if not found[name]]


def _require(target: str) -> Dict[str, Optional[str]]:
    found = probe()
    lacking = missing(target, found)
    if lacking:
        raise NativeBuildError(f"cannot build {target}: missing {', '.join(lacking)}")
    return found


def http_sources() -> List[Path]:
    return [NATIVE / "src" / name for name in HTTP_SOURCES] + [CSRC / "native_cuda_shm.cc"]


def _headers() -> List[Path]:
    return sorted((NATIVE / "include" / "client_tpu").glob("*.h"))


def _digest(paths: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for path in paths:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def _http_flags(found) -> List[str]:
    return [*CXX_FLAGS, f"-I{NATIVE / 'include'}",
            f"-I{os.path.dirname(os.path.dirname(found['curl/curl.h']))}"]


def _python_flags(found) -> List[str]:
    return [f"-I{NATIVE / 'include'}", f"-I{os.path.dirname(found['Python.h'])}"]


def http_library_path(found=None) -> Path:
    found = found or _require("http")
    flags = _http_flags(found) + [found["libcurl"], found["libz"], *HTTP_LIBS]
    return BUILD_DIR / f"libclient_tpu_torch_http.{_digest(http_sources() + _headers(), flags)}.so"


def embed_library_path(found=None) -> Path:
    found = found or _require("embed")
    flags = [*CXX_FLAGS, *_python_flags(found), found["libpython"]]
    src = [CSRC / "server_embed.cc", NATIVE / "include" / "client_tpu" / "server_embed.h"]
    return BUILD_DIR / f"libclient_tpu_torch_embed.{_digest(src, flags)}.so"


def embed_host_path(found=None) -> Path:
    found = found or _require("embed_host")
    library = embed_library_path(found)
    flags = [*C_FLAGS, *_python_flags(found), library.name]
    return BUILD_DIR / f"embed_host.{_digest([CSRC / 'embed_host.c'], flags)}"


def _run_all(commands: Sequence[List[str]], what: str) -> List[str]:
    """Run the compiler commands together; their logs, or raise naming the
    ones that failed."""
    started = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True) for cmd in commands]
    try:
        logs, failures = [], []
        for cmd, proc in zip(commands, started):
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\nexited {proc.returncode}:\n{out[-4000:]}")
        if failures:
            raise NativeBuildError(f"{what} failed:\n" + "\n".join(failures))
        return logs
    finally:
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _build_locked(target: Path, run) -> Dict[str, object]:
    """Build ``target`` under its file lock unless it exists: ``run(work)``
    writes ``work / "out"`` in a scratch directory and returns its command
    lines; the result is renamed into place. Returns ``{"path", "built",
    "seconds", "commands"}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    record: Dict[str, object] = {"path": str(target), "built": False, "seconds": 0.0,
                                 "commands": []}
    if target.exists():
        return record
    with open(target.with_name(target.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # a parallel worker built it meanwhile
            return record
        work = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir()
        t0 = time.perf_counter()
        try:
            record["commands"] = run(work)
            os.replace(work / "out", target)  # atomic
        finally:
            shutil.rmtree(work, ignore_errors=True)
        record.update(built=True, seconds=time.perf_counter() - t0)
    return record


def build_http() -> Dict[str, object]:
    """Build the HTTP/gRPC client library if it is missing: each source in
    a ``g++`` of its own, all together, then one link. Returns as
    :func:`_build_locked`."""
    found = _require("http")
    target = http_library_path(found)
    flags = _http_flags(found)

    def run(work: Path):
        compiles = [["g++", *flags, "-c", str(src), "-o", str(work / f"{src.stem}.o")]
                    for src in http_sources()]
        _run_all(compiles, "compiling the native client")
        link = ["g++", "-shared", "-o", str(work / "out"),
                *[str(work / f"{src.stem}.o") for src in http_sources()],
                found["libcurl"], found["libz"], *HTTP_LIBS]
        _run_all([link], "linking the native client")
        return compiles + [link]

    return _build_locked(target, run)


def build_embed() -> Dict[str, object]:
    """Build the embed library if it is missing. Returns as
    :func:`build_http`."""
    found = _require("embed")
    target = embed_library_path(found)
    libdir = os.path.dirname(found["libpython"])

    def run(work: Path):
        cmd = ["g++", *CXX_FLAGS, *_python_flags(found), "-shared",
               str(CSRC / "server_embed.cc"), "-o", str(work / "out"),
               found["libpython"], f"-Wl,-rpath,{libdir}"]
        _run_all([cmd], "building the embed library")
        return [cmd]

    return _build_locked(target, run)


def build_embed_host() -> Dict[str, object]:
    """Build the C host of the embed library (the library first, if it is
    missing). Returns as :func:`build_http`."""
    found = _require("embed_host")
    library = Path(build_embed()["path"])
    target = embed_host_path(found)

    def run(work: Path):
        cmd = ["gcc", *C_FLAGS, *_python_flags(found), str(CSRC / "embed_host.c"),
               "-o", str(work / "out"), str(library), f"-Wl,-rpath,{BUILD_DIR}"]
        _run_all([cmd], "building the embed host")
        return [cmd]

    return _build_locked(target, run)


def build_all(targets: Sequence[str] = ("http", "embed", "embed_host")) -> Dict[str, dict]:
    """Build ``targets`` (names of :data:`NEEDS`), each if missing."""
    build = {"http": build_http, "embed": build_embed, "embed_host": build_embed_host}
    return {name: build[name]() for name in targets}


def host_env() -> Dict[str, str]:
    """The environment of a C host process that embeds this interpreter:
    no ``PYTHONHOME`` (a venv's prefix is no installation home), and this
    interpreter's site-packages on ``PYTHONPATH`` (the host inserts the
    repository itself)."""
    import site

    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONHOME", "PYTHONPATH")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in site.getsitepackages() if os.path.isdir(p))
    return env


__all__ = ["BUILD_DIR", "HTTP_SOURCES", "NEEDS", "NativeBuildError", "build_all",
           "build_embed", "build_embed_host", "build_http", "curl_include_dirs",
           "curl_library_dirs", "embed_host_path",
           "embed_library_path", "host_env", "http_library_path", "http_sources", "missing",
           "probe"]
