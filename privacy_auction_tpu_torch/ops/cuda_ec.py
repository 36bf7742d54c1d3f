"""Wrappers of the hand-written CUDA kernels: the EC ladders
(`csrc/ec_ladders.cu`) and SHA-256 (`csrc/sha256.cu`).

The kernels are built with `nvcc` for sm_90a at first use into
`build/cuda_ec/` of the checkout, one library a source (`LIBRARIES`, one
nvcc each, started together), and bound through ctypes: pointers and
the stream go as `c_void_p`, counts as `c_int`.  Each wrapper checks
device, dtype and shapes, makes its inputs contiguous, allocates the output
with `torch.empty`, launches on the current stream, raises if the launcher
returns a CUDA error, and adds one to its launch count (a CUDA graph
adds its captured launches at each replay: `recorded`, `add_launches`).
There is no fallback: a CPU tensor, a missing `nvcc` or a failed build
raises.  The kernels hard-code secp256k1's p and its fold constant
(`csrc/ec_device.cuh`), so each wrapper takes the curve first and refuses
any other (`CURVE`); `ec.py` routes every other curve (P-256) to the plain
path before it gets here.

| wrapper            | kernel                     | TPU kernel it replaces                  |
| mul_comb           | mul_comb_kernel<G>         | _mul_base_kernel (pallas_ec.py:538)     |
| scalar_mul         | scalar_mul_kernel<G>       | _scalar_mul_kernel (pallas_ec.py:346)   |
| dual_mul           | dual_mul_kernel<G>         | _dual_mul_kernel (pallas_ec.py:366), at 33 and 64 windows |
| quad_mul           | quad_mul_kernel<G>         | _quad_mul_kernel (pallas_ec.py:404)     |
| base_mul_add_glv   | base_mul_add_glv_kernel<G> | _base_mul_add_glv_kernel (pallas_ec.py:436) |
| base_mul_add       | base_mul_add_kernel<G>     | _base_mul_add_kernel (pallas_ec.py:496) |
| pt_add             | pt_add_kernel<G>           | _pt_add_kernel (pallas_ec.py:399)       |
| sha256             | sha256_kernel              | none: the JAX package's SHA-256 loop (ops/sha256.py) |

The seven `<G>` kernels (GROUP_KERNELS) run G threads per lane
(`csrc/ec_group.cuh`), the six ladders with their window tables in shared
memory, pt_add with its block's points staged there; `launch_shape` gives
their grid, block and dynamic shared memory, which the launcher checks
against its build.  The constant tables (comb tables, the window-0 tables of
G and phi(G)) are packed to 32-bit words once per tensor and kept.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import pathlib
import re
import shutil
import subprocess
import time
import weakref

import torch

from ..curves import COMB_SIZE, COMB_WINDOWS

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("ec_ladders.cu", "ec_device.cuh", "ec_group.cuh", "sha256.cu")
# the libraries a build makes, each from one source
LIBRARIES = {"libpa_ec.so": "ec_ladders.cu", "libpa_sha256.so": "sha256.cu"}
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "cuda_ec"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the one curve the kernels are written for
CURVE = "secp256k1"
KERNELS = ("mul_comb", "dual_mul", "quad_mul", "base_mul_add_glv",
           "scalar_mul", "base_mul_add", "pt_add")
# the launch rows of the EC kernels: `dual_mul` counts its 64-window
# launches (full scalars, the ladder without GLV) under "dual_mul_64",
# apart from the 33-window launches that the GLV split gives it
EC_ROWS = KERNELS + ("dual_mul_64",)
# the hash kernel's row (it is curve-free: every curve's paths launch it)
SHA256 = "sha256"
# Launch counts by row.
launches = dict.fromkeys(EC_ROWS + (SHA256,), 0)
# The same launches by (row, lanes): how wide each launch was.
launch_lanes: dict[tuple[str, int], int] = {}

# The group kernels' launch shape (csrc/ec_group.cuh): G threads a lane.
# The Straus ladders (Shape<G>) run one warp of 32 // G lanes a block, with
# a 16-entry window table of 96 B entries in shared memory per source of
# each lane (scalar_mul: 1; dual_mul: 2; quad_mul: 4; base_mul_add: 1,
# besides the constant table of G once a block; base_mul_add_glv: 2,
# besides the two constant tables of G and phi(G) once a block).  mul_comb runs blocks of COMB_WARPS warps
# (comb_shape) over a ring of COMB_RING window tables of the comb.  pt_add
# runs one warp of 32 // G lanes a block, their points in shared memory.
# GROUP_STEPS: the G launch_shape takes, that of the first (lanes, G) whose
# lane count the launch does not pass (None: any).  G = 8 serves the small
# launches, a few warps an SM and latency-bound; above, fewer threads a lane
# do less work in all (measured on the H100 by tools/time_kernels_torch.py
# --groups, PERF.md).  GROUPS: the G each kernel is built for, those of its
# steps (csrc/ec_ladders.cu instantiates them).
GROUP_STEPS = {"mul_comb": ((4096, 8), (None, 2)),
               "dual_mul": ((2048, 8), (None, 4)),
               "quad_mul": ((2048, 8), (None, 4)),
               "base_mul_add_glv": ((2048, 8), (None, 4)),
               "scalar_mul": ((2048, 8), (None, 4)),
               "base_mul_add": ((2048, 8), (None, 4)),
               "pt_add": ((2048, 8), (None, 4))}
GROUPS = {k: tuple(g for _, g in steps) for k, steps in GROUP_STEPS.items()}
GROUP_KERNELS = tuple(GROUP_STEPS)
SMS = 132                # streaming multiprocessors of an H100 SXM
COMB_WARPS = (4, 12)     # warps a mul_comb block: least, most
COMB_RING = 2
WARP = 32
TABLE_BYTES = 16 * 96


def launch_shape(kernel: str, lanes: int,
                 group: int | None = None) -> tuple[int, int, int, int]:
    """(threads a lane G, blocks, threads a block, dynamic shared memory
    bytes a block) of a group kernel's launch over `lanes` lanes, with
    `group` threads a lane if given: lane l is served by the G threads from
    G * (l % per_block) of block l // per_block, per_block = threads // G."""
    if group is None:
        group = next(g for most, g in GROUP_STEPS[kernel]
                     if most is None or lanes <= most)
    if kernel == "mul_comb":
        return comb_shape(lanes, group)
    per_block = WARP // group
    if kernel == "pt_add":
        # the block's P and Q as 32-bit words, 96 B a point
        return group, -(-lanes // per_block), WARP, 2 * per_block * 96
    tables = {"scalar_mul": per_block, "dual_mul": 2 * per_block,
              "quad_mul": 4 * per_block, "base_mul_add": 1 + per_block,
              "base_mul_add_glv": 2 + 2 * per_block}[kernel]
    return group, -(-lanes // per_block), WARP, tables * TABLE_BYTES


def comb_shape(lanes: int, group: int, warps: int | None = None,
               ring: int = COMB_RING) -> tuple[int, int, int, int]:
    """mul_comb's launch shape with a ring of `ring` window tables (2 ...
    64; 64 holds the whole comb table) and `warps` warps a block, by
    default the fewest within COMB_WARPS that put at most one block on each
    SM: then each of an SM's four schedulers holds as many of the launch's
    warps as the others (measured on the H100, PERF.md)."""
    if warps is None:
        launch_warps = -(-lanes * group // WARP)
        warps = min(max(-(-launch_warps // SMS), COMB_WARPS[0]), COMB_WARPS[1])
    per_block = warps * WARP // group
    return group, -(-lanes // per_block), warps * WARP, ring * TABLE_BYTES


class Build:
    """The loaded libraries (`lib` the EC kernels', at `path`; `sha` the
    SHA-256 kernel's) and what their builds printed; `seconds` is None when
    an earlier build of the same sources and flags was loaded."""

    def __init__(self, lib: ctypes.CDLL, sha: ctypes.CDLL, path: pathlib.Path,
                 seconds: float | None, ptxas_log: str):
        self.lib = lib
        self.sha = sha
        self.path = path
        self.seconds = seconds
        self.ptxas_log = ptxas_log

    def resources(self) -> dict[str, dict]:
        """Per kernel (`kernel_key`), from ptxas' report: registers a
        thread, the stack frame (cumulative, bytes) and the kernel's spill
        stores and loads (bytes)."""
        out: dict[str, dict] = {}
        current = props = None
        for line in self.ptxas_log.splitlines():
            if "Compiling entry function" in line:
                current = kernel_key(line)
            elif "Function properties for" in line:
                props = kernel_key(line) if "_kernel" in line else None
            elif props and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                out.setdefault(props, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
                props = None
            elif current and (m := re.search(r"Used (\d+) registers", line)):
                # ptxas names no stack where the kernel has none
                st = re.search(r"(\d+) bytes cumulative stack", line)
                out.setdefault(current, {}).update(
                    registers=int(m.group(1)),
                    stack_bytes=int(st.group(1)) if st else 0)
        return out


def _row(name: str) -> str | None:
    """The wrapper whose kernel a mangled name holds."""
    return next((k for k in KERNELS + (SHA256,) if f"{k}_kernel" in name),
                None)


def kernel_key(name: str) -> str | None:
    """The wrapper of a mangled kernel name, with the threads a lane of a
    group kernel: "quad_mul<8>" for quad_mul_kernel<8>."""
    row = _row(name)
    m = re.search(r"_kernelILi(\d+)E", name)
    return f"{row}<{m.group(1)}>" if row and m else row


_build: Build | None = None


def reset_launches():
    for name in launches:
        launches[name] = 0
    launch_lanes.clear()


def _count(row: str, n: int, times: int = 1):
    if n:
        launches[row] += times
        launch_lanes[(row, n)] = launch_lanes.get((row, n), 0) + times


@contextlib.contextmanager
def recorded():
    """Takes the launches made inside out of the counts and gives them, by
    (row, lanes), in the dict it yields: the launches of a CUDA graph's
    capture, which `add_launches` counts at each replay, or of a warm-up
    run, which are not counted."""
    before = dict(launch_lanes)
    seen: dict[tuple[str, int], int] = {}
    try:
        yield seen
    finally:
        for key, v in launch_lanes.items():
            if v != before.get(key, 0):
                seen[key] = v - before.get(key, 0)
        reset_launches()
        for (row, n), v in before.items():
            _count(row, n, v)


def add_launches(seen: dict):
    """Count the launches of `recorded`'s dict once more (a graph's replay)."""
    for (row, n), v in seen.items():
        _count(row, n, v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA ladder kernels cannot be built")


def build() -> Build:
    """Load the kernel libraries, compiling them first when no build of
    these sources and flags exists: one nvcc a library, all started
    together.  The build directory is named by their hash; a new build is
    written under temporary names and renamed into place, so a process
    never overwrites a library another one has loaded."""
    global _build
    if _build is not None:
        return _build
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    paths = {name: out_dir / name for name in LIBRARIES}
    log_path = out_dir / "ptxas.log"
    seconds = None
    if not all(p.exists() for p in paths.values()):
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = {name: out_dir / f"{name}.{os.getpid()}" for name in LIBRARIES}
        tmp_log = out_dir / f"ptxas.{os.getpid()}.log"
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp[name]), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, src in LIBRARIES.items()}
        logs = {name: proc.communicate()[1] for name, proc in procs.items()}
        seconds = time.perf_counter() - t0
        for name, proc in procs.items():
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {LIBRARIES[name]} failed "
                                   f"({proc.returncode}):\n{logs[name]}")
        tmp_log.write_text("".join(logs.values()))
        os.replace(tmp_log, log_path)
        for name in LIBRARIES:
            os.replace(tmp[name], paths[name])
    lib = ctypes.CDLL(str(paths["libpa_ec.so"]))
    sha = ctypes.CDLL(str(paths["libpa_sha256.so"]))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pa_mul_comb.argtypes = [P, P, P] + [I] * 5 + [P]
    lib.pa_dual_mul.argtypes = [P] * 5 + [I] * 6 + [P]
    lib.pa_quad_mul.argtypes = [P] * 9 + [I] * 6 + [P]
    lib.pa_base_mul_add_glv.argtypes = [P] * 9 + [I] * 6 + [P]
    lib.pa_scalar_mul.argtypes = [P, P, P] + [I] * 6 + [P]
    lib.pa_base_mul_add.argtypes = [P] * 5 + [I] * 5 + [P]
    lib.pa_pt_add.argtypes = [P, P, P] + [I] * 5 + [P]
    for fn in (lib.pa_mul_comb, lib.pa_dual_mul, lib.pa_quad_mul,
               lib.pa_base_mul_add_glv, lib.pa_scalar_mul, lib.pa_base_mul_add,
               lib.pa_pt_add):
        fn.restype = I
    L = ctypes.c_longlong
    sha.pa_sha256.argtypes = [P, P, L, L, I, I, P]
    sha.pa_sha256_chain_clocks.argtypes = [P, I, P, P, P]
    sha.pa_sha256.restype = sha.pa_sha256_chain_clocks.restype = I
    _build = Build(lib, sha, paths["libpa_ec.so"], seconds, log_path.read_text())
    return _build


# --------------------------------------------------------------------------
# CUDA graphs: kernel nodes, instantiation timed apart from the capture
# --------------------------------------------------------------------------

CU_GRAPH_NODE_TYPE_KERNEL = 0


def instantiate(graph) -> tuple[int, float]:
    """Instantiate a graph captured with `keep_graph=True`: (its kernel
    nodes, read through the driver API, and the seconds the instantiation
    took)."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _check("cuGraphGetNodes", cu.cuGraphGetNodes(handle, None,
                                                 ctypes.byref(count)))
    nodes = (ctypes.c_void_p * count.value)()
    _check("cuGraphGetNodes", cu.cuGraphGetNodes(handle, nodes,
                                                 ctypes.byref(count)))
    kind = ctypes.c_int()
    kernels = 0
    for node in nodes:
        _check("cuGraphNodeGetType",
               cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
        kernels += kind.value == CU_GRAPH_NODE_TYPE_KERNEL
    t0 = time.perf_counter()
    graph.instantiate()
    return kernels, time.perf_counter() - t0


# --------------------------------------------------------------------------
# the table selects in SASS
# --------------------------------------------------------------------------

# The kernels that look up window tables by a secret digit (every group
# kernel but pt_add), and the name of their select function (pt_select16_shared,
# __noinline__, so it is a function of its own in every kernel's SASS).
SELECT_KERNELS = tuple(k for k in GROUP_KERNELS if k != "pt_add")
SELECT_NAME = "pt_select16_shared"
ENTRY_BYTES = 96
_PRED = r"(@!?U?P[T0-9]+\s+)?"
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LOAD = re.compile(_PRED + r"(U?LD[A-Z]*)((?:\.\w+)*)\s")
_BRA = re.compile(_PRED + r"BRA\S*\s+(?:`\()?(0x[0-9a-f]+)")
_WIDTH = {"128": 16, "64": 8, "U8": 1, "S8": 1, "U16": 2, "S16": 2}


def _cuobjdump(b: Build, what: str) -> str:
    tool = pathlib.Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), what, str(b.path)], capture_output=True,
                          text=True, check=True).stdout


def select_sass(b: Build) -> list[dict]:
    """Each table select of each kernel as compiled: its load instructions
    (`LD`, `LDS`, `LDG`, `LDL`, `LDC` and their vector and uniform forms),
    how many are predicated, how many bytes of table they read, and its
    branches.  `ok` holds when no load is predicated, the code is straight
    (no branch, so every load issues once a call) and the loads read all 16
    entries of 96 B; a kernel of SELECT_KERNELS without a select function
    is reported not ok.  Functions are found through the ELF symbol table
    (`$kernel$function`, with offset and size) and read from `cuobjdump
    -sass`."""
    funcs: dict[str, list] = {}
    for line in _cuobjdump(b, "-elf").splitlines():
        f = line.split()
        if len(f) == 7 and f[-1].startswith("$") and SELECT_NAME in f[-1]:
            kernel, fn = f[-1][1:].split("$", 1)
            funcs.setdefault(kernel, []).append((fn, int(f[1], 16), int(f[2], 16)))
    code: dict[str, list] = {}
    kernel = None
    for line in _cuobjdump(b, "-sass").splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            code[kernel] = []
        elif kernel and (m := _INSN.search(line)):
            code[kernel].append((int(m.group(1), 16), m.group(2).strip()))
    report = []
    for kernel, fns in funcs.items():
        row = _row(kernel) or kernel
        for fn, start, size in fns:
            body = [(a, t) for a, t in code.get(kernel, ())
                    if start <= a < start + size]
            loads = [t for _, t in body if _LOAD.match(t)]
            table_bytes = 0
            for t in loads:
                m = _LOAD.match(t)
                if "LDC" not in m.group(2):
                    sizes = [_WIDTH[x] for x in m.group(3).split(".") if x in _WIDTH]
                    table_bytes += sizes[0] if sizes else 4
            branches = [t for a, t in body
                        if (m := _BRA.match(t)) and int(m.group(2), 16) != a]
            predicated = sum(t.startswith("@") for t in loads)
            report.append({
                "kernel": row, "variant": kernel_key(kernel) or kernel,
                "select": fn, "instructions": len(body),
                "loads": len(loads), "predicated_loads": predicated,
                "table_bytes": table_bytes, "branches": len(branches),
                "ok": (bool(body) and predicated == 0 and not branches
                       and table_bytes >= 16 * ENTRY_BYTES)})
    # a kernel that looks up tables but shows no select function fails
    for kernel in code:
        if _row(kernel) in SELECT_KERNELS and kernel not in funcs:
            report.append({"kernel": _row(kernel), "variant": kernel_key(kernel),
                           "select": None, "instructions": 0, "loads": 0,
                           "predicated_loads": 0, "table_bytes": 0,
                           "branches": 0, "ok": False})
    return report


# --------------------------------------------------------------------------
# argument checks and layout
# --------------------------------------------------------------------------

def _check_curve(name: str, curve):
    if curve.name != CURVE:
        raise ValueError(f"{name}: the kernel is written for {CURVE}'s field, "
                         f"not {curve.name}'s; ec.py runs that curve's plain "
                         "path")


def _lanes(name: str, tensors, tails):
    """Check that every tensor is int64 on one CUDA device with the given
    trailing shape and one common batch shape; return them flattened to
    contiguous (N, *tail) and the batch shape."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {dev}")
    batch = None
    flat = []
    for t, tail in zip(tensors, tails):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64 limbs, got {t.dtype}")
        if t.dim() < len(tail) or tuple(t.shape[t.dim() - len(tail):]) != tail:
            raise ValueError(f"{name}: expected trailing shape {tail}, got "
                             f"{tuple(t.shape)}")
        b = tuple(t.shape[: t.dim() - len(tail)])
        if batch is None:
            batch = b
        elif b != batch:
            raise ValueError(f"{name}: batch shapes {b} and {batch} differ")
        flat.append(t.reshape((-1,) + tail).contiguous())
    return flat, batch


def pack_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 16) 16-bit limbs -> (..., 8) 32-bit words (int32 bit patterns)."""
    w = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32).contiguous()


_packed: dict[int, tuple] = {}


def packed_words(table: torch.Tensor) -> torch.Tensor:
    """`pack_words(table)`, made once per table tensor and kept while the
    tensor lives and is not written to (its version counter)."""
    key = id(table)
    hit = _packed.get(key)
    if hit is not None and hit[0]() is table and hit[1] == table._version:
        return hit[2]
    words = pack_words(table)
    ref = weakref.ref(table, lambda _, key=key: _packed.pop(key, None))
    _packed[key] = (ref, table._version, words)
    return words


def _out(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty((n, 3, 16), dtype=torch.int64, device=like.device)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

# `shape` of the group kernels' wrappers: the launch shape to take in place
# of launch_shape's, to time or check one choice of G (tools, card tests).

def mul_comb(curve, table: torch.Tensor, k: torch.Tensor,
             shape=None) -> torch.Tensor:
    """k*B for a (64, 16, 3, 16) comb table of B; k (..., 16)."""
    _check_curve("mul_comb", curve)
    (kf,), batch = _lanes("mul_comb", [k], [(16,)])
    if tuple(table.shape) != (COMB_WINDOWS, COMB_SIZE, 3, 16):
        raise ValueError(f"mul_comb: bad comb table shape {tuple(table.shape)}")
    if table.device != k.device:
        raise ValueError("mul_comb: table and scalars on different devices")
    words = packed_words(table)
    n = kf.shape[0]
    out = _out(n, kf)
    lib = build().lib
    _check("mul_comb", lib.pa_mul_comb(
        _ptr(kf), _ptr(words), _ptr(out), n,
        *(shape or launch_shape("mul_comb", n)), _stream(kf.device)))
    _count("mul_comb", n)
    return out.reshape(batch + (3, 16))


def _check_windows(name: str, windows: int):
    if not 1 <= windows <= COMB_WINDOWS:
        raise ValueError(f"{name}: windows={windows} out of range")


def scalar_mul(curve, P, k, windows: int = COMB_WINDOWS,
               shape=None) -> torch.Tensor:
    """k*P over the low `windows` 4-bit windows (all 64 by default)."""
    _check_curve("scalar_mul", curve)
    (p, s), batch = _lanes("scalar_mul", [P, k], [(3, 16), (16,)])
    _check_windows("scalar_mul", windows)
    n = p.shape[0]
    out = _out(n, p)
    lib = build().lib
    _check("scalar_mul", lib.pa_scalar_mul(
        _ptr(p), _ptr(s), _ptr(out), n, windows,
        *(shape or launch_shape("scalar_mul", n)), _stream(p.device)))
    _count("scalar_mul", n)
    return out.reshape(batch + (3, 16))


def dual_mul(curve, P1, k1, P2, k2, windows: int, shape=None) -> torch.Tensor:
    """k1*P1 + k2*P2 over the low `windows` 4-bit windows."""
    _check_curve("dual_mul", curve)
    (p1, s1, p2, s2), batch = _lanes(
        "dual_mul", [P1, k1, P2, k2], [(3, 16), (16,), (3, 16), (16,)])
    _check_windows("dual_mul", windows)
    n = p1.shape[0]
    out = _out(n, p1)
    lib = build().lib
    _check("dual_mul", lib.pa_dual_mul(
        _ptr(p1), _ptr(s1), _ptr(p2), _ptr(s2), _ptr(out), n, windows,
        *(shape or launch_shape("dual_mul", n)), _stream(p1.device)))
    _count("dual_mul_64" if windows == COMB_WINDOWS else "dual_mul", n)
    return out.reshape(batch + (3, 16))


def quad_mul(curve, P1, k1, P2, k2, P3, k3, P4, k4, windows: int,
             shape=None) -> torch.Tensor:
    """sum k_i*P_i over the low `windows` 4-bit windows."""
    _check_curve("quad_mul", curve)
    args, batch = _lanes("quad_mul", [P1, k1, P2, k2, P3, k3, P4, k4],
                         [(3, 16), (16,)] * 4)
    _check_windows("quad_mul", windows)
    n = args[0].shape[0]
    out = _out(n, args[0])
    lib = build().lib
    _check("quad_mul", lib.pa_quad_mul(
        *[_ptr(a) for a in args], _ptr(out), n, windows,
        *(shape or launch_shape("quad_mul", n)), _stream(args[0].device)))
    _count("quad_mul", n)
    return out.reshape(batch + (3, 16))


def base_mul_add_glv(curve, P1, t1, P2, t2, s1, s2, sflags, g0_tables,
                     windows: int, shape=None) -> torch.Tensor:
    """g^s * P^t from the GLV split (see ec.base_mul_add_glv_plain);
    g0_tables (2, 16, 3, 16): window-0 entries of G and phi(G)."""
    _check_curve("base_mul_add_glv", curve)
    args, batch = _lanes(
        "base_mul_add_glv", [P1, t1, P2, t2, s1, s2, sflags],
        [(3, 16), (16,), (3, 16), (16,), (16,), (16,), (2,)])
    if tuple(g0_tables.shape) != (2, COMB_SIZE, 3, 16):
        raise ValueError(f"base_mul_add_glv: bad g0 table shape "
                         f"{tuple(g0_tables.shape)}")
    _check_windows("base_mul_add_glv", windows)
    words = packed_words(g0_tables.to(args[0].device))
    n = args[0].shape[0]
    out = _out(n, args[0])
    lib = build().lib
    _check("base_mul_add_glv", lib.pa_base_mul_add_glv(
        *[_ptr(a) for a in args], _ptr(words), _ptr(out), n, windows,
        *(shape or launch_shape("base_mul_add_glv", n)),
        _stream(args[0].device)))
    _count("base_mul_add_glv", n)
    return out.reshape(batch + (3, 16))


def base_mul_add(curve, s, P, t, g0_table, shape=None) -> torch.Tensor:
    """g^s * P^t without GLV over the 64 4-bit windows of the full scalars;
    g0_table (16, 3, 16): the window-0 comb entries d*G (Z = 1)."""
    _check_curve("base_mul_add", curve)
    (p, tt, ss), batch = _lanes("base_mul_add", [P, t, s],
                                [(3, 16), (16,), (16,)])
    if tuple(g0_table.shape) != (COMB_SIZE, 3, 16):
        raise ValueError(f"base_mul_add: bad g0 table shape "
                         f"{tuple(g0_table.shape)}")
    words = packed_words(g0_table.to(p.device))
    n = p.shape[0]
    out = _out(n, p)
    lib = build().lib
    _check("base_mul_add", lib.pa_base_mul_add(
        _ptr(p), _ptr(tt), _ptr(ss), _ptr(words), _ptr(out), n,
        *(shape or launch_shape("base_mul_add", n)), _stream(p.device)))
    _count("base_mul_add", n)
    return out.reshape(batch + (3, 16))


def pt_add(curve, P, Q, shape=None) -> torch.Tensor:
    """One complete projective add P + Q per lane."""
    _check_curve("pt_add", curve)
    (p, q), batch = _lanes("pt_add", [P, Q], [(3, 16), (3, 16)])
    # the kernel reads and writes 16-byte chunks: a view that starts
    # within a chunk (a whole point is 384 B) is copied to its own storage
    p, q = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (p, q))
    n = p.shape[0]
    out = _out(n, p)
    lib = build().lib
    _check("pt_add", lib.pa_pt_add(
        _ptr(p), _ptr(q), _ptr(out), n,
        *(shape or launch_shape("pt_add", n)), _stream(p.device)))
    _count("pt_add", n)
    return out.reshape(batch + (3, 16))


# SHA-256: one thread a message, in blocks of this many threads (a lane's
# chain of blocks bounds the batches the paths hash, so few threads a block
# spread them over more SMs)
SHA256_THREADS = 64


def sha256(msg: torch.Tensor) -> torch.Tensor:
    """SHA-256 of (..., L) uint8 messages on the card -> (..., 8) int64
    digest words (big-endian H0..H7), one launch; the padding is made in
    the kernel."""
    if msg.device.type != "cuda":
        raise ValueError(f"sha256: the kernel needs CUDA tensors, got "
                         f"{msg.device}")
    if msg.dtype != torch.uint8:
        raise TypeError(f"sha256: expected uint8 bytes, got {msg.dtype}")
    batch, L = tuple(msg.shape[:-1]), msg.shape[-1]
    n = math.prod(batch)
    m = msg.reshape(n, L).contiguous()
    out = torch.empty((n, 8), dtype=torch.int64, device=m.device)
    aligned = int(L % 4 == 0 and m.data_ptr() % 4 == 0)
    _check("sha256", build().sha.pa_sha256(
        _ptr(m), _ptr(out), n, L, SHA256_THREADS, aligned, _stream(m.device)))
    _count(SHA256, n)
    return out.reshape(batch + (8,))


def sha256_chain_clocks(device, reps: int = 1 << 16) -> float:
    """The clocks one link of SHA-256's critical chain takes on `device`
    (Sigma1 of e, then the add that makes the new e; csrc/sha256.cu), from
    one thread timing `reps` links with clock64(): a round's least latency,
    for the bound of a lane's chain."""
    words = torch.tensor([0x6A09E667, 0x0BB67AE8, 0x3C6EF372],
                         dtype=torch.int32, device=device)
    clocks = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    _check("sha256_chain_clocks", build().sha.pa_sha256_chain_clocks(
        _ptr(words), reps, _ptr(clocks), _ptr(sink), _stream(device)))
    return int(clocks.item()) / reps


# --------------------------------------------------------------------------
# work counts for the operations bound
# --------------------------------------------------------------------------

# 32-bit integer multiplies that the point formulas need, for the bound.
# Each wide (32x32 -> 64) product is two 32-bit multiply results (low and
# high word).  A field mul is 64 schoolbook products plus 9 in the fold by
# 2^32 + 977; a squaring needs 36 products (the kernels do 64); a mul by a
# small odd constant (3, 21, 63) is 8 products plus 1 in the fold; a mul by
# 2 or 8 is a shift, and only its fold multiplies (1 product; the kernels
# do a small-constant mul).
MULS_FE_MUL = 2 * (64 + 9)
MULS_FE_SQR = 2 * (36 + 9)
MULS_FE_SMALL = 2 * (8 + 1)
MULS_FE_SHIFT = 2 * 1
# RCB16 Alg 7: 12 muls, small muls by 3, 21, 21
MULS_PT_ADD = 12 * MULS_FE_MUL + 3 * MULS_FE_SMALL
# RCB16 Alg 9: 6 muls and 2 squarings (Y^2, Z^2), small muls by 21 and 63,
# shifts by 8 and 2
MULS_PT_DBL = (6 * MULS_FE_MUL + 2 * MULS_FE_SQR + 2 * MULS_FE_SMALL
               + 2 * MULS_FE_SHIFT)


def int_muls(kernel: str, lanes: int, windows: int = 33) -> int:
    """32-bit integer multiplies the kernel's function needs for `lanes`
    lanes, at the counts above (the kernels are constant-time: the count
    does not depend on the data)."""
    if kernel == "mul_comb":
        adds, dbls = COMB_WINDOWS, 0
    elif kernel == "pt_add":
        adds, dbls = 1, 0
    elif kernel == "scalar_mul":
        adds, dbls = 14 + windows, 4 * windows
    elif kernel == "base_mul_add":
        adds, dbls = 14 + 2 * windows, 4 * windows
    elif kernel == "dual_mul":
        adds, dbls = 2 * 14 + 2 * windows, 4 * windows
    elif kernel == "quad_mul":
        adds, dbls = 4 * 14 + 4 * windows, 4 * windows
    elif kernel == "base_mul_add_glv":
        # + two Y negations (field subs, no multiplies) per window
        adds, dbls = 2 * 14 + 4 * windows, 4 * windows
    else:
        raise ValueError(kernel)
    return lanes * (adds * MULS_PT_ADD + dbls * MULS_PT_DBL)


# 32-bit integer operations of one SHA-256 block, for the bound: a round
# is Sigma1 and Sigma0 (three funnel shifts and a 3-input xor each), Ch
# and Maj (one 3-input logic op each) and four adds (T1's five terms in
# two 3-input adds, d + T1, T1 + T2 in one 3-input add); each of the 48
# scheduled words is sigma0 and sigma1 (two funnel shifts, a shift and a
# 3-input xor each) and two 3-input adds; then 8 adds into the state.
# Loads and the assembly of words from bytes are not counted.
SHA256_OPS_PER_BLOCK = 64 * (4 + 4 + 1 + 1 + 4) + 48 * (4 + 4 + 2) + 8


def sha256_blocks(msg_len: int) -> int:
    """The blocks of a padded message of msg_len bytes."""
    return (msg_len + 9 + 63) // 64
