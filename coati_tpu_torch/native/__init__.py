"""Native (C) host-side components: the canonical-SMILES pipeline
(fast_canon.c) and the vocabulary matcher (fast_matcher.c).

The port's own loader for byte-for-byte copies of coati_tpu/native/*.c.
Each source compiles at first use, never at import, with the system C
compiler (`$CC`, else cc, gcc or clang; `-O3 -shared -fPIC`, well under a
second) into coati_tpu_torch/_build/ (listed in .gitignore), keyed on a hash
of the source and the flags, and loads through ctypes. Without a compiler,
or with COATI_TPU_NO_NATIVE=1, the loaders return None and every consumer
takes its pure-Python path, which gives the same results: the native layer
is an accelerator, never a requirement. `BUILD_ERRORS` keeps the
compiler's output of a failed build, and `CANON_PATHS` counts which path
answered each canonicalization (chem/graph_canon.py), so that nothing falls
back unseen.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC")

# canonicalizations answered by fast_canon.c and by the Python pipeline
CANON_PATHS = {"native": 0, "python": 0}
# source name -> the compiler's output of a build that failed
BUILD_ERRORS: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def _compiler() -> Optional[str]:
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    return None


def library_path(name: str) -> Path:
    digest = hashlib.sha256((NATIVE_DIR / f"{name}.c").read_bytes())
    digest.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile_and_load(name: str, pydll: bool) -> Optional[ctypes.CDLL]:
    if os.environ.get("COATI_TPU_NO_NATIVE") == "1":
        return None
    cc = _compiler()
    if cc is None:
        BUILD_ERRORS[name] = "no C compiler ($CC, cc, gcc, clang) on the PATH"
        return None
    target = library_path(name)
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(NATIVE_DIR / f"{name}.c")],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        except (subprocess.CalledProcessError, OSError) as ex:
            tmp.unlink(missing_ok=True)
            BUILD_ERRORS[name] = (f"{cc} exited {ex.returncode}:\n{ex.stdout}{ex.stderr}"
                                  if isinstance(ex, subprocess.CalledProcessError) else f"{cc}: {ex}")
            return None
    try:
        # PyDLL keeps the GIL held during calls: fast_canon.c uses static
        # scratch buffers and is not reentrant
        return ctypes.PyDLL(str(target)) if pydll else ctypes.CDLL(str(target))
    except OSError as ex:
        BUILD_ERRORS[name] = f"loading {target}: {ex}"
        return None


def _load(name: str, pydll: bool, declare) -> Optional[ctypes.CDLL]:
    with _lock:
        if name not in _libs:
            lib = _compile_and_load(name, pydll)
            if lib is not None:
                declare(lib)
            _libs[name] = lib
        return _libs[name]


def _declare_matcher(lib: ctypes.CDLL) -> None:
    lib.matcher_new.restype = ctypes.c_void_p
    lib.matcher_new.argtypes = []
    lib.matcher_free.argtypes = [ctypes.c_void_p]
    lib.matcher_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.matcher_split.restype = ctypes.c_int32
    lib.matcher_split.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
    ]


def _declare_canon(lib: ctypes.CDLL) -> None:
    lib.canonical_smiles_native.restype = ctypes.c_int
    lib.canonical_smiles_native.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]


def load_fast_matcher() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native leftmost-longest matcher; None
    if unavailable."""
    return _load("fast_matcher", False, _declare_matcher)


def load_fast_canon() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native canonical-SMILES pipeline
    (parse, kekulize, perceive, rank, search, write: byte-identical to
    chem/graph_canon + chem/selfies_lite); None if unavailable."""
    return _load("fast_canon", True, _declare_canon)
