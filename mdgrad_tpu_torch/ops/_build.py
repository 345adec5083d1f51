"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes`` -- no PyTorch headers, so the
build takes seconds, not the minutes that ``torch.utils.cpp_extension``
needs.  The library lands in
``mdgrad_tpu_torch/_build/`` (ignored by git) under a name that hashes the
sources and flags, so an edited source is rebuilt at its first use and an
unchanged one is loaded as it is.  Nothing is built when a module is
imported: :func:`library` builds on the first kernel launch.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types; pointers and the stream go as
# c_void_p, or ctypes would pass them as 32-bit ints
SIGNATURES = {
    "mdg_gather_mul_reduce": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mdg_table_gather": (_P, _P, _P, _I, _I, _I, _P),
    "mdg_table_scatter": (_P, _P, _P, _P, _I, _I, _P),
    # the same three over bf16 rows (split=False; csrc/gather.cu)
    "mdg_gather_mul_reduce_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mdg_table_gather_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "mdg_table_scatter_bf16": (_P, _P, _P, _P, _I, _I, _P),
    "mdg_table_index_csr": (_P, _I, _I, _P, _P, _P, _I, _P),
    "mdg_table_index_csr_one_block": (_I, _I),
    "mdg_rdf_scratch": (_I, _I, _I, _I),
    "mdg_rdf_reach_arg": (),
    "mdg_rdf_counts": (_P, _I, _I, *(_F,) * 10, _P, _P, _I, _P, _P, _P),
    "mdg_rdf_counts_bwd": (_P, _I, _I, *(_F,) * 10, _P, _P, _P, _I, _P, _P,
                           _P),
    "mdg_pair_tile": (),
    "mdg_force_tile": (),
    "mdg_lj_scratch": (_I, _I, _I),
    # the four LJ pair kernels, picked by the first argument (csrc/pair.cu)
    "mdg_lj_pair": (_I, _P, _P, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                    _P, _P, _I, _I, _P, _P, _P, _P, _P),
}

# entry points that return another type than int
RESTYPES = {"mdg_rdf_scratch": ctypes.c_longlong,
            "mdg_lj_scratch": ctypes.c_longlong,
            "mdg_rdf_reach_arg": ctypes.c_float}

build_seconds = None   # wall time of the last build in this process


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = pathlib.Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(sources=None):
    """Where the library of ``sources`` (every ``csrc/*.cu`` by default)
    lives: its name hashes the flags and the name and bytes of each source
    and of every ``csrc/*.cuh`` header, so an edited header rebuilds it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    for src in map(pathlib.Path, [*(sources or _sources()), *headers]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmdgrad_kernels_{digest.hexdigest()[:16]}.so"


def build(path, sources=None):
    """Compile ``sources`` (every ``csrc/*.cu`` by default) into ``path``:
    one nvcc process per source, run in parallel, then one link.  The
    compilers' output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) goes to a ``.log`` of the same name beside it."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = list(map(pathlib.Path, sources or _sources()))
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    # -I: a source outside csrc/ (another version, timed against this
    # one) finds the headers too
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj),
             str(src)]
            for src, obj in zip(sources, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, proc in zip(cmds, procs)]
    if all(code == 0 for _, _, code in outputs):
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        outputs.append((cmd, proc.stdout, proc.returncode))
    build_seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in outputs)
    path.with_suffix(".log").write_text(log)
    failed = [(cmd, out, code) for cmd, out, code in outputs if code != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out, code = failed[0]
        raise RuntimeError(f"{' '.join(cmd)} failed ({code}):\n{out}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing


@functools.cache
def library(sources=None):
    """The loaded kernel library, built first if its sources changed;
    ``sources``, a tuple of ``.cu`` paths, builds and loads another (to
    time a kernel against another version of its source), with the entry
    points that it defines."""
    path = library_path(sources)
    if not path.exists():
        build(path, sources)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if sources and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    if hasattr(lib, "mdg_error_string"):   # gather.cu's
        lib.mdg_error_string.argtypes = [ctypes.c_int]
        lib.mdg_error_string.restype = ctypes.c_char_p
    return lib


def check(code, name):
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().mdg_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def on_cuda(tensor):
    """True for a CUDA tensor (the wrapper launches its kernel), False for
    a CPU tensor (the plain version); any other device raises."""
    if tensor.is_cuda:
        return True
    if tensor.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device "
                     f"{tensor.device}")


def stream_of(tensor):
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
