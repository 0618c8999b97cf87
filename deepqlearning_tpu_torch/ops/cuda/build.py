"""Build and load the port's CUDA kernels (``deepqlearning_tpu_torch/csrc``).

The ``*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into ``csrc/_build/``; the
file name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is loaded as it is. The library is bound
with ``ctypes``: pointers and streams are passed as ``c_void_p`` and every
launch function returns ``cudaGetLastError()``, which :func:`check` turns
into an exception. A failed build raises; nothing falls back to the plain
PyTorch versions.

Every call of an entry point that launches work (all but the
``*_max_grid`` queries) adds 1 to the recorder's counter
``kernels.launches`` under the entry point's name (``dq_td_loss``,
``dq_fused_grads``, ...): the one count of the port's kernel launches.
Each entry point launches at most one kernel. It counts Python calls, so
inside a CUDA graph the warm-up and the capture count and the replays do
not; the recorder's ``enabled = False`` stops it too.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAXL = 16  # DQ_MAXL of csrc/common.cuh
DR_MAXL = 16  # DR_MAXL of csrc/fused_drqn.cu
DR_MAXT = 2 * DR_MAXL + 3
TS_MAXL = 8  # TS_MAXL of csrc/tree_sample.cu


class NetDesc(ctypes.Structure):
    """Mirror of ``struct NetDesc`` in ``csrc/common.cuh``."""

    _fields_ = [
        ("dueling", ctypes.c_int), ("n_val", ctypes.c_int),
        ("n_adv", ctypes.c_int), ("in_dim", ctypes.c_int),
        ("num_actions", ctypes.c_int), ("n_params", ctypes.c_int),
        ("maxw", ctypes.c_int), ("h_per_row", ctypes.c_int),
        ("din", ctypes.c_int * MAXL), ("dout", ctypes.c_int * MAXL),
        ("act", ctypes.c_int * MAXL), ("off_w", ctypes.c_int * MAXL),
        ("off_b", ctypes.c_int * MAXL), ("off_h", ctypes.c_int * MAXL),
    ]


FC_MAXCELLS = 16  # FC_MAXCELLS of csrc/fused_collect.cu
FC_MAXK = 16  # FC_MAXK


class EnvDesc(ctypes.Structure):
    """Mirror of ``struct EnvDesc`` in ``csrc/fused_collect.cu``."""

    _fields_ = [
        ("kind", ctypes.c_int), ("n_cells", ctypes.c_int),
        ("cell_x", ctypes.c_float * FC_MAXCELLS),
        ("cell_y", ctypes.c_float * FC_MAXCELLS),
        ("cell_r", ctypes.c_float * FC_MAXCELLS),
        ("k", ctypes.c_float * FC_MAXK),
    ]


class TreeLevels(ctypes.Structure):
    """Mirror of ``struct TreeLevels`` in ``csrc/tree_sample.cu``."""

    _fields_ = [("lv", ctypes.c_void_p * TS_MAXL),
                ("size", ctypes.c_int * TS_MAXL),
                ("bf", ctypes.c_int * TS_MAXL), ("n", ctypes.c_int)]


class DrqnDesc(ctypes.Structure):
    """Mirror of ``struct DrqnDesc`` in ``csrc/fused_drqn.cu``."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "cell", "n_pre", "n_val", "n_adv", "dueling", "in_dim", "cin",
            "H", "G", "A", "T", "n_params", "n_tensors", "n_witems", "tile",
            "rp", "act_global")]
        + [(n, ctypes.c_int * DR_MAXL) for n in (
            "din", "dout", "act", "off_w", "off_b", "sw", "ldw", "sb",
            "in_a", "off_a", "off_d")]
        + [(n, ctypes.c_int) for n in (
            "off_wi", "off_wh", "off_bc", "s_wi", "ld_wi", "s_wh", "ld_wh",
            "s_bc", "cell_in", "a_gates", "a_aux", "a_c", "a_h",
            "step_floats", "d_gates", "d_dg", "cot_floats", "r_cot",
            "r_steps", "r_x", "r_x2", "r_tgt", "r_rew", "r_done", "r_mask",
            "r_act", "r_hub", "region_floats", "n_sp", "f_sp2",
            "f_state", "f_ht", "f_xt", "f_region", "smem_floats")]
        + [(n, ctypes.c_int * DR_MAXT) for n in (
            "t_off", "t_size", "t_dst", "t_ld", "t_cols")]
        + [("w_start", ctypes.c_int * (DR_MAXT + 1))]
    )


AD_MAXT = 64  # AD_MAXT of csrc/adam.cu
AD_MAXB = 1024  # AD_MAXB


class AdamTab(ctypes.Structure):
    """Mirror of ``struct AdamTab`` in ``csrc/adam.cu``."""

    _fields_ = [
        ("p", ctypes.c_void_p * AD_MAXT), ("m", ctypes.c_void_p * AD_MAXT),
        ("v", ctypes.c_void_p * AD_MAXT), ("g", ctypes.c_void_p * AD_MAXT),
        ("n", ctypes.c_int * AD_MAXT), ("start", ctypes.c_int * (AD_MAXT + 1)),
        ("flags", ctypes.c_int * AD_MAXT), ("nt", ctypes.c_int),
        ("k", (ctypes.c_float * 6) * 2),
    ]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdq_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands at once; raise on the first that fails. Returns
    their stderr, in order."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    outs = [(cmd, p, *p.communicate()) for cmd, p in procs]
    for cmd, p, out, err in outs:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")
    return [err for _, _, _, err in outs]


def build() -> Path:
    """Compile the library if this source hash has not been built yet: one
    ``nvcc`` per source, all started together, then one link. ptxas's
    report (registers, stack, spills per kernel) is kept beside it."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{tag}.{src.stem}.o"
            for src in sources() if src.suffix == ".cu"}
    logs = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                 for src, obj in objs.items()])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([[_nvcc(), "-shared", "-o", str(tmp),
           *[str(o) for o in objs.values()]]])
    for obj in objs.values():
        obj.unlink()
    out.with_suffix(".ptxas.txt").write_text("".join(logs))
    os.replace(tmp, out)
    return out


def ptxas_report(kernels):
    """``{kernel: ptxas's line}`` (stack frame, spills, registers) for the
    named kernels of the built library. A template on ints has a line per
    instantiation, keyed ``kernel<n>`` (``fc_kernel<1>``)."""
    lines = build().with_suffix(".ptxas.txt").read_text().splitlines()
    found = {}
    for i, line in enumerate(lines):
        for k in kernels:
            tag = f"{len(k)}{k}"
            if "Compiling entry" not in line or tag not in line:
                continue
            key = k
            ints = re.match(r"I((?:Li\d+E)+)E", line.split(tag, 1)[1])
            if ints:
                key = f"{k}<{','.join(re.findall(r'Li(\d+)E', ints[1]))}>"
            found[key] = " | ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                if "Function properties" not in x
                and "Compiling entry" not in x)
    return found


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its signatures
    (the span ``kernels.load``; the counter ``kernels.nvcc_builds`` is 1
    where it ran ``nvcc``, 0 where the library was built already)."""
    from ...utils import profiling

    with profiling.span("kernels.load"):
        built = _library_path().exists()
        lib = _bind(ctypes.CDLL(str(build())))
    profiling.count("kernels.nvcc_builds", int(not built))
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L = ctypes.c_longlong
    NP = ctypes.POINTER(NetDesc)
    I64P = ctypes.POINTER(ctypes.c_int64)
    sig = {
        "dq_td_loss": [P, P, P, P, I, L, P, L, P, L, P, L, I, I, F, F, F, I,
                       P, P, P, P, P],
        "dq_empty": [I, P],
        "dq_tree_sample": [ctypes.POINTER(TreeLevels), P, I, I, P, P, P],
        "dq_fused_update": [NP, I64P, I64P, I64P, P, I, I, P, P, P, P, P, P,
                            P, F, F, F, I, F, F, F, F, P, P, P, P, P, P, P,
                            I, P],
        "dq_fused_update_max_grid": [NP, ctypes.POINTER(ctypes.c_int)],
        "dq_fused_collect": [NP, I64P, ctypes.POINTER(EnvDesc), P, P, P,
                             P, P, I, I, P, I, P, P, P, P, P, P, P],
        "dq_fused_collect_rnn": [NP, I64P, I, I, I, P, P, P,
                                 ctypes.POINTER(EnvDesc), P, P, P, P, P, P,
                                 I, I, P, I, P, P, P, P, P, P, P, P],
        "dq_fused_drqn": [ctypes.POINTER(DrqnDesc), I64P, I64P, I64P, P, I,
                          I, P, P, P, P, P, P, P, F, I, F, F, F, F, P, P, P,
                          P, P, P, I, P],
        "dq_fused_drqn_max_grid": [ctypes.POINTER(DrqnDesc),
                                   ctypes.POINTER(ctypes.c_int)],
        "dq_fused_grads": [NP, I64P, I, P, P, P, P, P, P, P, F, F, F, I, P,
                           P, P, P, P, P, P, I, P],
        "dq_fused_adam": [NP, I64P, I64P, I64P, P, I, P, F, F, F, F, P, P],
        "dq_fused_drqn_grads": [ctypes.POINTER(DrqnDesc), I64P, I, P, P,
                                P, P, P, P, P, F, I, P, P, P, P, P, P, I, P],
        "dq_drqn_adam": [ctypes.POINTER(DrqnDesc), I64P, I64P, I64P, P, I, P,
                         F, F, F, F, P, P],
        "dq_drqn_target": [ctypes.POINTER(DrqnDesc), I64P, I, P, P, P],
        "dq_adam_update": [ctypes.POINTER(AdamTab), P, F, F, P, I, I, I, P,
                           P],
        "dq_bias_act": [P, I, P, I, P, I, P, I, I, I, I, I, I, I, P],
        "dq_bias_act_grad": [P, I, P, P, I, P, I, P, P, P, I, I, I, I, I, I,
                             I, I, P],
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        if not name.endswith("_max_grid"):
            setattr(lib, name, _counted(name, fn))
    lib.dq_error_string.argtypes = [ctypes.c_int]
    lib.dq_error_string.restype = ctypes.c_char_p
    return lib


def _counted(name: str, fn):
    """``fn``, adding 1 to ``kernels.launches`` under ``name`` per call."""
    from ...utils import profiling

    def launch(*args):
        profiling.count("kernels.launches", 1, name)
        return fn(*args)

    return launch


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = library().dq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def int64_array(values):
    return (ctypes.c_int64 * len(values))(*values)


def require_shape(t, shape, name: str) -> None:
    """Raise unless ``t`` has exactly ``shape``: the kernels index raw
    pointers with these sizes."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def require_plan_params(plan, tensors) -> None:
    """The parameter tensors (plan order w0, b0, ...) match the plan."""
    for lp, (w, b) in zip(plan.layers, zip(tensors[::2], tensors[1::2])):
        require_shape(w, (lp.din, lp.dout), lp.w_name)
        require_shape(b, (lp.dout,), lp.b_name)


def require_cuda(*tensors) -> None:
    """Every tensor must be a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")


# CUgraphNodeType of the CUDA driver API (cuda.h)
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


@functools.lru_cache(maxsize=None)
def _driver() -> ctypes.CDLL:
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    for fn in (cu.cuGraphGetNodes, cu.cuGraphNodeGetType):
        fn.restype = ctypes.c_int
    return cu


def graph_nodes(graph: int) -> dict:
    """The nodes of a captured CUDA graph (``cudaGraph_t``, which is the
    driver's ``CUgraph``, as ``torch.cuda.CUDAGraph(keep_graph=True)
    .raw_cuda_graph()`` gives it) by node type: ``{"kernel": n, ...}``."""
    cu = _driver()
    n = ctypes.c_size_t(0)
    _driver_check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    _driver_check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)))
    out, kind = {}, ctypes.c_int()
    for node in nodes[:n.value]:
        _driver_check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
        name = (NODE_TYPES[kind.value] if kind.value < len(NODE_TYPES)
                else f"type{kind.value}")
        out[name] = out.get(name, 0) + 1
    return out


def _driver_check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"counting a CUDA graph's nodes: CUDA driver "
                           f"error {err}")
