"""Build the CUDA kernels in csrc/ and the host code in native/ at first use
and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, `build/lib<name>-<hash>.so`; the hash covers the source
and every header, so an edited kernel never loads a stale build. Each
`native/<name>.cpp` (the rANS codec and the I420 converter) compiles the
same way with g++ (`HOST_FLAGS`). A file lock per library serialises
concurrent builds of it (several processes may start at once); `build_all`
runs one compiler per source, all at once. A failed build raises with the
compiler's output. The library is loaded with ctypes, and `bind` gives
its C entries their types from a table, once. A kernel library takes
every pointer and the stream as `c_void_p`, and each of its C entries
returns `cudaGetLastError()`: `launch` calls an entry on a device's
current stream, turns its error into an exception (`check`) and counts
the launch as the recorder's `launches.<wrapper>` counter
(`utils.profiling.RECORDER`; `utils.graphs.launch_counts` reads them).

Nothing here runs at import: the CPU tests import every module, and only
a call on a CUDA tensor builds a kernel; the host libraries build at their
first call, on either device.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from gsvc_tpu_torch.utils.profiling import RECORDER

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
NATIVE_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# the C types of kernel entries' arguments in `bind`'s tables: pointers
# and streams, int and int64
VP, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LAUNCHES = "launches."  # + a wrapper's name: the recorder's counter of its launches

_libs: dict = {}
_bound: dict = {}  # name -> the library of `bind`, its table's types set
_libs_lock = threading.Lock()
# the entries every kernel library has (csrc/common.cuh)
_KERNEL_ENTRIES = {"gsvc_error_string": (ctypes.c_char_p, [I32]),
                   "gsvc_empty_launch": (I32, [VP])}
# seconds each library's compiler ran in this process (absent: it was built)
build_seconds: dict = {}


def is_host(name: str) -> bool:
    """Whether `name` is a host library (native/<name>.cpp), not a kernel's."""
    return (NATIVE_DIR / f"{name}.cpp").is_file()


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native rANS and I420 code "
                           "(gsvc_tpu_torch/native) need a host C++ compiler")
    return gxx


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source(name: str) -> Path:
    return NATIVE_DIR / f"{name}.cpp" if is_host(name) else CSRC_DIR / f"{name}.cu"


def _source_hash(name: str) -> str:
    src = _source(name)
    if is_host(name):
        h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
        deps = [src]
    else:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        deps = [src] + sorted(CSRC_DIR.glob("*.cuh"))
    for p in deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def _command(name: str, out: Path) -> list:
    if is_host(name):
        return [_gxx(), *HOST_FLAGS, "-o", str(out), str(_source(name))]
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out), str(_source(name))]


def _compile(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".lock-{name}", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
            cmd = _command(name, tmp)
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                src = _source(name)
                raise RuntimeError(
                    f"{Path(cmd[0]).name} failed for {src.parent.name}/{src.name}:\n"
                    f"{' '.join(cmd)}\n"
                    f"{res.stdout}{res.stderr}"
                )
            build_seconds[name] = time.perf_counter() - t0
            out.with_suffix(".log").write_text(res.stdout + res.stderr)
            os.replace(tmp, out)
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu or native/<name>.cpp, compiled
    on first use."""
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            if not is_host(name):
                _set_types(lib, _KERNEL_ENTRIES)
            _libs[name] = lib
        return lib


def bind(name: str, table: dict) -> ctypes.CDLL:
    """`load(name)` with each C entry of `table`, {entry: (restype,
    argtypes)}, given its types, once a process."""
    lib = _bound.get(name)
    if lib is None:
        lib = load(name)
        with _libs_lock:
            _set_types(lib, table)
            _bound[name] = lib
    return lib


def _set_types(lib: ctypes.CDLL, table: dict) -> None:
    for entry, (restype, argtypes) in table.items():
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = restype, list(argtypes)


def build_all(names) -> None:
    """Compile the named libraries in parallel (one compiler each), then load."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(_compile, names))
    for name in names:
        load(name)


def build_log(name: str) -> str:
    """The compiler's output of a build (for a kernel, ptxas's register and
    shared-memory use)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def resources(log: str) -> list:
    """[(kernel, ptxas's "Used ..." line)] of a build log, in its order."""
    out, kernel = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            kernel = m.group(1)
        elif "Used" in ln and kernel is not None:
            out.append((kernel, ln.split("Used", 1)[1].strip()))
            kernel = None
    return out


def empty_launch(device) -> None:
    """Launch one empty kernel (csrc/common.cuh) on the device's current
    stream: the floor under every kernel's time. On the CPU there is no
    kernel, and nothing is done."""
    import torch

    if torch.device(device).type != "cuda":
        return
    lib = load("fill")
    check(lib, lib.gsvc_empty_launch(stream_ptr(device)), "gsvc_empty_launch")


def launch(lib: ctypes.CDLL, entry: str, device, *args, counter: str = "") -> None:
    """Call the kernel entry `entry` of `lib` on `args` and the current
    stream of CUDA `device` (its last argument), with `device` current;
    raise on its CUDA error (`check`), else count the launch as the
    recorder's `launches.<counter>` (default: the entry's name)."""
    import torch

    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, stream_ptr(device))
    counter = counter or entry
    check(lib, rc, counter)
    RECORDER.add(LAUNCHES + counter)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.gsvc_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
