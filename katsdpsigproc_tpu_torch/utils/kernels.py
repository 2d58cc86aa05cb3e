"""Build and load the port's CUDA kernels.

Each kernel library is compiled by ``nvcc`` on first use into a shared
library with a plain C interface, then loaded with :mod:`ctypes` (no
PyTorch headers are compiled, so a build takes seconds).  The build goes
to ``build/katsdpsigproc_tpu_torch/<name>-<hash>/`` beside the package,
keyed by a hash of the sources, the shared headers under ``csrc/``, the
generated headers and the flags (:func:`build_key`),
so a changed source or header is rebuilt and an unchanged one is reused.
The library is written under a temporary name and renamed into place,
so processes that build the same key at once cannot see a partial file.
Builds of different libraries may run at once from several threads (each
key has its own lock), so a caller can start every ``nvcc`` together.

Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "katsdpsigproc_tpu_torch"

# No --use_fast_math: sqrtf and division stay IEEE.  -fmad=false keeps
# every a*b+c rounded twice, as the JAX reference's kernel computes it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()  # guards _key_locks
_key_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
# Per build key: nvcc's messages (register and shared-memory use; kept as
# nvcc.log beside the library, so a reused library reports them too) and
# the seconds the build took (0 when an existing library was reused).
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                       "toolkit is installed (on PATH or under CUDA_HOME)")


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}.{threading.get_ident()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def build_key(name: str, sources: Sequence[str], headers: Dict[str, str]) -> str:
    """The build directory's name: `name` and a hash of all the build reads.

    The hash covers the flags, the listed sources, every ``*.cuh`` and
    ``*.h`` under ``csrc/`` (any source may include any of them) and the
    generated headers.
    """
    shared = sorted(p.relative_to(CSRC_DIR).as_posix() for p in CSRC_DIR.rglob("*")
                    if p.suffix in (".cuh", ".h") and p.is_file())
    digest = hashlib.sha256()
    for part in (name, *NVCC_FLAGS):
        digest.update(part.encode() + b"\0")
    for src in (*sources, *shared):
        digest.update(src.encode() + b"\0" + (CSRC_DIR / src).read_bytes() + b"\0")
    for hname in sorted(headers):
        digest.update(hname.encode() + b"\0" + headers[hname].encode() + b"\0")
    return f"{name}-{digest.hexdigest()[:16]}"


def load(name: str, sources: Sequence[str], headers: Dict[str, str]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so`` from ``csrc/`` sources.

    `sources` are file names under ``csrc/``; `headers` maps generated
    header names to their text, written beside the library and found
    first on the include path.  Raises ``RuntimeError`` with nvcc's
    output if the build fails.
    """
    key = build_key(name, sources, headers)
    with _lock:
        key_lock = _key_locks.setdefault(key, threading.Lock())
    with key_lock:
        lib = _loaded.get(key)
        if lib is not None:
            return lib
        out_dir = BUILD_DIR / key
        so = out_dir / f"lib{name}.so"
        log = out_dir / "nvcc.log"
        info = {"seconds": 0.0, "log": log.read_text() if log.exists() else ""}
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            for hname, text in headers.items():
                _write_atomic(out_dir / hname, text.encode())
            tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(out_dir), "-I", str(CSRC_DIR),
                   "-o", str(tmp), *(str(CSRC_DIR / s) for s in sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}) building {key}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            info = {"seconds": time.perf_counter() - t0, "log": proc.stdout + proc.stderr}
            _write_atomic(log, info["log"].encode())
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        build_info[key] = info
        _loaded[key] = lib
        return lib
