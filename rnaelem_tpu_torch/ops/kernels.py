"""Build and ctypes bindings of the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
process per source, all started together, then one link) into a shared
library with a plain C interface under ``build/kernels/<hash>/``, keyed on
a hash of the sources and flags.  Nothing is compiled or imported from
CUDA when this module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with torch, launches on the current stream of its
tensors' device, raises when the launch returns a CUDA error, and counts
its launches in ``KERNELS[name].launches`` (and per variant of a launch
plan in ``KERNELS[name].variants``).  Kernels are instantiated for
float32 (production) and float64 (held to the plain versions).

The blocks of K3, K6 and K11, of the M chain (K2, K5, K10) and of the
no-rss chain (K8, K9) hold scratch sized by the grammar, the max internal
loop and the type: their launch plans (ep_plan, band_plan, chain_plan)
are worked out on the host from those alone, before any launch, and
always name a hand-written kernel.  K14-K17
(rows C and D: the factors and the hoisted exponentials, forward and
adjoint) run once per evaluation, and so do K18-K21 (rows G-I, K, O: the
masks' candidates and threshold, a pass's ends and the objective,
lambda's per-read sums, the scanner's posteriors).

The scanner's aux factors reach the kernels as an ``Aux`` struct
(csrc/common.cuh): the grammar's class codes, the evaluation's pin
(ConstFactors.pin, or none) and, in the outside pass when the class
probe DiffFactors.cls is given, the class-partial buffers that K7 and K5
fill and K5's ``cls_red`` sums into the probe's cotangent.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .dp import AUX, GRAD_TABLES, MAX_PINS, pin_set

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
SOURCES = ("score_tables.cu", "inside_band.cu", "inside_ep.cu",
           "inside_ext.cu", "outside_band.cu", "outside_ep.cu",
           "outside_ext.cu", "linear_fwd.cu", "linear_adj.cu",
           "cyk_traceback.cu", "factors.cu", "hoisted.cu", "bpp_keep.cu",
           "ends.cu", "lam_sum.cu", "posteriors.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "librnaelem_kernels.so"


class Kernel:
    """One hand-written kernel (a .cu source), its launch count and the
    count of each variant of its launch plan that ran."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name, self.source, self.replaces = name, source, replaces
        self.launches = 0
        self.variants = {}


KERNELS = {
    "score_tables": Kernel("score_tables",
                           "rnaelem_tpu_torch/csrc/score_tables.cu",
                           "rnaelem_tpu/energy/tables.py:97"),
    "inside_band": Kernel("inside_band",
                          "rnaelem_tpu_torch/csrc/inside_band.cu",
                          "rnaelem_tpu/ops/dp.py:352"),
    "inside_ep": Kernel("inside_ep", "rnaelem_tpu_torch/csrc/inside_ep.cu",
                        "rnaelem_tpu/ops/dp.py:477"),
    "inside_ext": Kernel("inside_ext",
                         "rnaelem_tpu_torch/csrc/inside_ext.cu",
                         "rnaelem_tpu/ops/dp.py:601"),
    "outside_band": Kernel("outside_band",
                           "rnaelem_tpu_torch/csrc/outside_band.cu",
                           "rnaelem_tpu/ops/dp.py:788"),
    "outside_ep": Kernel("outside_ep",
                         "rnaelem_tpu_torch/csrc/outside_ep.cu",
                         "rnaelem_tpu/ops/dp.py:788"),
    "outside_ext": Kernel("outside_ext",
                          "rnaelem_tpu_torch/csrc/outside_ext.cu",
                          "rnaelem_tpu/ops/dp.py:788"),
    "linear_fwd": Kernel("linear_fwd",
                         "rnaelem_tpu_torch/csrc/linear_fwd.cu",
                         "rnaelem_tpu/model/joint.py:594"),
    "linear_adj": Kernel("linear_adj",
                         "rnaelem_tpu_torch/csrc/linear_adj.cu",
                         "rnaelem_tpu/model/joint.py:594"),
    # K10-K12: the max-semiring instantiations of K2-K4 (the CYK tables)
    "inside_band_max": Kernel("inside_band_max",
                              "rnaelem_tpu_torch/csrc/inside_band.cu",
                              "rnaelem_tpu/ops/dp_maxb.py:137"),
    "inside_ep_max": Kernel("inside_ep_max",
                            "rnaelem_tpu_torch/csrc/inside_ep.cu",
                            "rnaelem_tpu/ops/dp_maxb.py:219"),
    "inside_ext_max": Kernel("inside_ext_max",
                             "rnaelem_tpu_torch/csrc/inside_ext.cu",
                             "rnaelem_tpu/ops/dp_maxb.py:340"),
    "cyk_traceback": Kernel("cyk_traceback",
                            "rnaelem_tpu_torch/csrc/cyk_traceback.cu",
                            "rnaelem_tpu/ops/dp_maxb.py:459"),
    # K14-K17: rows C and D, the factors and the hoisted exponentials
    "factors": Kernel("factors", "rnaelem_tpu_torch/csrc/factors.cu",
                      "rnaelem_tpu/model/joint.py:313"),
    "factors_adj": Kernel("factors_adj", "rnaelem_tpu_torch/csrc/factors.cu",
                          "rnaelem_tpu/model/joint.py:436"),
    "hoisted": Kernel("hoisted", "rnaelem_tpu_torch/csrc/hoisted.cu",
                      "rnaelem_tpu/ops/dp.py:290"),
    "hoisted_adj": Kernel("hoisted_adj", "rnaelem_tpu_torch/csrc/hoisted.cu",
                          "rnaelem_tpu/ops/dp.py:828"),
    # K18-K21: the passes' ends, the masks' threshold and the scanner's
    # posteriors (rows G, H, I, K and O)
    "bpp_keep": Kernel("bpp_keep", "rnaelem_tpu_torch/csrc/bpp_keep.cu",
                       "rnaelem_tpu/model/joint.py:518"),
    "parts": Kernel("parts", "rnaelem_tpu_torch/csrc/ends.cu",
                    "rnaelem_tpu/ops/dp.py:771"),
    "lam_sum": Kernel("lam_sum", "rnaelem_tpu_torch/csrc/lam_sum.cu",
                      "rnaelem_tpu/ops/dp.py:812"),
    "posteriors": Kernel("posteriors", "rnaelem_tpu_torch/csrc/posteriors.cu",
                         "rnaelem_tpu/scan/scanner.py:147"),
}


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0
        k.variants = {}


# ---------------------------------------------------------------- build

def build_dir() -> Path:
    env = os.environ.get("RNAELEM_KERNEL_BUILD_DIR")
    return Path(env) if env else PKG.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def _source_hash(extra=()) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(extra)).encode())
    return h.hexdigest()[:16]


def build(extra_flags=()) -> tuple:
    """Compile csrc/*.cu into the shared library (if not built yet).
    Returns (path, compiler log); ``extra_flags`` such as
    ("-Xptxas", "-v") go to every nvcc call."""
    out_dir = build_dir() / _source_hash(extra_flags)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = list(NVCC_FLAGS) + list(extra_flags) + ["-I", str(CSRC)]
    procs = []
    for src in SOURCES:
        obj = out_dir / (src + ".%d.o" % os.getpid())
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *flags, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, p in procs:
        text, _ = p.communicate()
        log.append("== %s\n%s" % (src, text))
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s"
                           % (", ".join(failed), "\n".join(log)))
    tmp = out_dir / (LIB_NAME + ".%d.tmp" % os.getpid())
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return lib_path, "\n".join(log)


# ---------------------------------------------------------- C interface

class DPDims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "Lp", "Wp", "Cp", "S", "B", "PAD", "j", "n13", "n_ar", "n2",
        "n_cls", "Tp", "fix_rss", "no_ene", "n_pt")]


N_TABLES = 23


class ScoreDims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "Lp", "Wp", "B", "max_span", "turn", "no_ene", "fix_rss")] + [
        ("off", ctypes.c_int * N_TABLES)]


class ScoreGrid(ctypes.Structure):  # csrc/score_tables.cu, score_plan
    _fields_ = [(n, ctypes.c_int) for n in (
        "G", "lgG", "J", "lgDJ", "bands", "groups", "smem")]


class ChainDims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("Lp", "S", "B")]


class ChainGrid(ctypes.Structure):  # csrc/chain.cuh, from chain_plan
    _fields_ = [(n, ctypes.c_int) for n in (
        "NC", "R", "nnz", "threads", "dev", "smem", "ws_stride")]


class AuxArg(ctypes.Structure):
    _fields_ = [("code", ctypes.c_void_p),
                ("pin", ctypes.c_void_p * MAX_PINS),
                ("pin_bit", ctypes.c_int * MAX_PINS),
                ("pin_kinds", ctypes.c_int * MAX_PINS),
                ("cpR", ctypes.c_void_p), ("cpL", ctypes.c_void_p)]


def _ptr_struct(name, fields):
    return type(name, (ctypes.Structure,),
                {"_fields_": [(f, ctypes.c_void_p) for f in fields]})


BAND_IDX = ("rt_off", "rt_s", "rt_w", "lt_off", "lt_s", "lt_w", "pt_lt",
            "diag", "loopm", "bucket", "pt_code", "pt_wl", "pt_wr",
            "b12_off", "b12_a", "b12_c")
EP_IDX = ("p13_s1", "p13_s3", "ar_off", "ar_p", "k2_s2", "k2_ar", "k2_bu",
          "k2_off", "k2_idx", "p13_ar", "k2_tgt", "s1_off", "s1_k", "s3_off",
          "s3_k", "k2a_off", "k2a_k", "k2s_off", "k2s_k")
EXT_IDX = ("rt_off", "rt_s", "rt_w", "bucket", "op_off", "op_a", "op_c")
ADJ_IDX = ("rt_off", "rt_s", "rt_w", "rtr_off", "rtr_t", "rtr_w", "ltr_off",
           "ltr_t", "ltr_w", "pt_lt", "loopm", "bucket", "pt_code", "pt_wl",
           "pt_wr", "ptl_t", "ptl_s", "b12a_off", "b12a_t", "b12a_c",
           "b12c_off", "b12c_t", "b12c_a")
CHAIN_IDX = ("rt_off", "rt_s", "rt_w", "rtr_off", "rtr_t", "rtr_w",
             "end_states")
TB_DATA = ("LL", "P", "E", "M", "Bt", "T1", "T2", "O", "eR", "eL", "bg2",
           "pv", "wsp", "gate_O2", "gate_M", "hp", "stk", "ext", "ml2", "mlE",
           "misA", "misB", "SZ", "spec_il", "lam", "C", "L", "dcum")
BandIdx = _ptr_struct("BandIdx", BAND_IDX)
AdjIdx = _ptr_struct("AdjIdx", ADJ_IDX)
EpIdx = _ptr_struct("EpIdx", EP_IDX)
ExtIdx = _ptr_struct("ExtIdx", EXT_IDX)
ChainIdx = _ptr_struct("ChainIdx", CHAIN_IDX)
TbData = _ptr_struct("TbData", TB_DATA)


class FacDims(ctypes.Structure):   # csrc/factors.cu
    _fields_ = [(n, ctypes.c_int) for n in (
        "Lp", "Wp", "S", "B", "Tp", "ns", "mode", "theta_softmax",
        "no_theta", "no_prf", "fix_rss", "turn", "max_span",
        "max_iloop")] + [("sbs", ctypes.c_longlong), ("sbp", ctypes.c_longlong)]


class HoistDims(ctypes.Structure):  # csrc/hoisted.cu
    _fields_ = [(n, ctypes.c_int) for n in (
        "Lp", "Wp", "Cp", "B", "PAD", "n_cls")] + [
        ("lam_s0", ctypes.c_longlong), ("lam_s1", ctypes.c_longlong)]


class HoistGrid(ctypes.Structure):  # csrc/hoisted.cu, from hoisted_plan
    _fields_ = [(n, ctypes.c_int) for n in (
        "V", "TX", "TY", "nub", "nb1", "nb2", "nb3", "groups")]


class FacGrid(ctypes.Structure):   # csrc/factors.cu, from factors_plan
    _fields_ = [(n, ctypes.c_int) for n in (
        "V", "TX", "TY", "G", "P", "n1", "n2", "n3", "n4", "groups", "smem")]


FAC_IDX = ("slot_r", "slot_l", "ws_r", "ws_l", "rs_off", "rs_s", "ls_off",
           "ls_s")
FAC_OUT = ("eR", "eL", "bg2", "pv", "alphaP", "lam", "seq64", "seqT", "L64",
           "dcum", "dcumT", "gate", "C", "wsp")
FAC_ADJ = ("geR", "geL", "gbg2", "gpv", "gs", "gp", "ws", "done")
HOIST_IN = ("lam", "SZT", "grp", "misA", "misB", "C")
HOIST_OUT = ("eSZ", "eSZg", "emisA", "emisB")
FacIdx = _ptr_struct("FacIdx", FAC_IDX)
FacOut = _ptr_struct("FacOut", FAC_OUT)
FacAdjArgs = _ptr_struct("FacAdjArgs", FAC_ADJ)
HoistIn = _ptr_struct("HoistIn", HOIST_IN)
HoistOut = _ptr_struct("HoistOut", HOIST_OUT)


# K13's grammar lists (csrc/cyk_traceback.cu TbLists): the int32 lists in
# one buffer, the scalar ones in another, each at its offset; pt packs a
# pair transition's table code (-1 none, -2 background) and its two
# positional-weight flags as ((code + 2) << 2) | (wl << 1) | wr.
TB_INT_LISTS = ("rt_off", "rt_s", "lt_off", "lt_s", "pt", "loopm", "bucket",
                "end_states", "state_l", "state_r", "op_off", "op_a", "op_c",
                "b12_off", "b12_a", "b12_c", "ept_off", "ept_s1", "ept_s2",
                "ept_s3")
TB_SCALAR_LISTS = ("rt_w", "lt_w", "pt_lt")


class TbLists(ctypes.Structure):  # csrc/cyk_traceback.cu
    _fields_ = [("iv", ctypes.c_void_p), ("tv", ctypes.c_void_p),
                ("ni", ctypes.c_int), ("nt", ctypes.c_int)] + [
        (n, ctypes.c_int) for n in TB_INT_LISTS + TB_SCALAR_LISTS]


class TbGrid(ctypes.Structure):  # csrc/cyk_traceback.cu, traceback_plan
    _fields_ = [(n, ctypes.c_int) for n in (
        "NW", "stack_smem", "lists_smem", "smem")]


class TbCfg(ctypes.Structure):
    _fields_ = [("eps", ctypes.c_double), ("cap", ctypes.c_int)]


class EndsArgs(ctypes.Structure):  # csrc/ends.cu
    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "S", "PAD", "mode", "lik_ratio")] + [
        (n, ctypes.c_void_p) for n in (
            "O", "L", "end_states", "parts_in", "parts", "y", "y2",
            "restrict_ari", "is_neg", "valid", "lik_sign", "eff", "gy",
            "gparts", "gbar", "gO")]


class LamSumArgs(ctypes.Structure):  # csrc/lam_sum.cu
    _fields_ = [(n, ctypes.c_int) for n in ("n", "S", "B")] + [
        (n, ctypes.c_void_p) for n in ("DL", "lam", "extra", "states")] + [
        ("off", ctypes.c_int * 3)] + [
        (n, ctypes.c_void_p) for n in ("out", "ws", "done")]


class BppArgs(ctypes.Structure):  # csrc/bpp_keep.cu
    _fields_ = [(n, ctypes.c_int) for n in (
        "Lp", "Wp", "B", "max_span", "wmin")] + [
        (n, ctypes.c_void_p) for n in (
            "seq", "L", "pair", "bp0", "sel", "post")] + [
        ("log_min_bpp", ctypes.c_double)] + [
        (n, ctypes.c_void_p) for n in ("out", "eff")]


class PostArgs(ctypes.Structure):  # csrc/posteriors.cu
    _fields_ = [(n, ctypes.c_int) for n in ("Lp", "B", "end")] + [
        (n, ctypes.c_void_p) for n in ("g", "L", "P0", "P1", "arg", "pin")]


class ExtAdjListsArg(ctypes.Structure):  # csrc/outside_ext.cu ExtAdjLists
    _fields_ = [("idx", ctypes.c_void_p), ("wt", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("nA", "nC", "nO", "nR", "nT")]


# exported function -> (leading struct argtypes, number of pointers[,
# number of trailing ints])
_SIGS = {
    "score_tables": ((ScoreDims, ScoreGrid), 19),
    "band_front": ((DPDims, BandIdx, AuxArg), 15),
    "band_bif": ((DPDims, BandIdx), 4),
    "band_m": ((DPDims, BandIdx, AuxArg), 6, 3),
    "band_e": ((DPDims, BandIdx), 8),
    "ep_fwd": ((DPDims, EpIdx), 13),
    "ep_fwd_red": ((DPDims,), 3),
    "ext_col": ((DPDims, ExtIdx, AuxArg), 6),
    "ext_adj": ((DPDims, ExtAdjListsArg, AuxArg), 10),
    "e_adj": ((DPDims, AdjIdx), 12),
    "m_adj": ((DPDims, AdjIdx, AuxArg), 11, 3),
    "bif_adj": ((DPDims, AdjIdx), 6),
    "front_adj_t": ((DPDims, AdjIdx, AuxArg), 19),
    "front_adj_sw": ((DPDims, AdjIdx, AuxArg), 23),
    "cls_red": ((DPDims, AuxArg), 1),
    "ep_adj": ((DPDims, EpIdx), 20),
    "ep_adj_red": ((DPDims,), 8),
    "chain_fwd": ((ChainDims, ChainIdx, AuxArg, ChainGrid), 4),
    "chain_adj": ((ChainDims, ChainIdx, AuxArg, ChainGrid), 6),
    "band_front_max": ((DPDims, BandIdx, AuxArg), 15),
    "band_bif_max": ((DPDims, BandIdx), 4),
    "band_m_max": ((DPDims, BandIdx, AuxArg), 6, 3),
    "band_e_max": ((DPDims, BandIdx), 8),
    "ep_max": ((DPDims, EpIdx), 13),
    "ext_col_max": ((DPDims, ExtIdx, AuxArg), 6),
    "cyk_traceback": ((DPDims, TbLists, AuxArg, TbData, TbCfg, TbGrid), 5),
    "factors": ((FacDims, FacIdx, FacOut, FacGrid), 6),
    "factors_adj": ((FacDims, FacIdx, FacAdjArgs), 3, 6),
    "hoisted": ((HoistDims, HoistIn, HoistOut, HoistGrid), 0),
    "hoisted_adj": ((HoistDims, HoistIn, HoistOut), 3, 3),
    "bpp_candidates": ((BppArgs,), 0),
    "bpp_keep": ((BppArgs,), 0),
    "ends_fwd": ((EndsArgs,), 0),
    "ends_adj": ((EndsArgs,), 0),
    "lam_sum": ((LamSumArgs,), 0, 1),
    "posteriors": ((PostArgs,), 0),
}
_SUF = {torch.float32: "f32", torch.float64: "f64"}

_lib = None
_lock = threading.Lock()


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            L = ctypes.CDLL(str(path))
            for name, sig in _SIGS.items():
                structs, nptr, nint = (sig + (0,))[:3]
                for suf in _SUF.values():
                    fn = getattr(L, "rnaelem_%s_%s" % (name, suf))
                    fn.argtypes = list(structs) + [ctypes.c_void_p] * nptr \
                        + [ctypes.c_int] * nint + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
            L.rnaelem_ep_smem_bytes.argtypes = [ctypes.c_int, DPDims,
                                                ctypes.c_int]
            L.rnaelem_ep_smem_bytes.restype = ctypes.c_longlong
            L.rnaelem_ep_ws_bytes.argtypes = [ctypes.c_int, DPDims,
                                              ctypes.c_int]
            L.rnaelem_ep_ws_bytes.restype = ctypes.c_longlong
            L.rnaelem_ep_max_ranges.argtypes = [DPDims, ctypes.c_int,
                                                ctypes.c_int]
            L.rnaelem_ep_max_ranges.restype = ctypes.c_int
            L.rnaelem_band_smem_bytes.argtypes = [ctypes.c_int] * 5
            L.rnaelem_band_smem_bytes.restype = ctypes.c_longlong
            L.rnaelem_chain_smem_bytes.argtypes = [ctypes.c_int] * 5
            L.rnaelem_chain_smem_bytes.restype = ctypes.c_longlong
            L.rnaelem_error_string.argtypes = [ctypes.c_int]
            L.rnaelem_error_string.restype = ctypes.c_char_p
            _lib = L
    return _lib


def _call(kernel: str, fname: str, like, *args, variant=None, dtype=None):
    """Launch rnaelem_<fname>_<type> for the dtype of the tensor ``like``
    (or ``dtype``) on its device's current stream, that device made
    current for the launch when it is not (a process may hold tensors on
    several cards); raise on a CUDA error; count the launch against
    ``kernel`` (and against its plan's ``variant``, if any)."""
    dtype = like.dtype if dtype is None else dtype
    if dtype not in _SUF:
        raise TypeError("kernels take float32 or float64, not %s" % dtype)
    L = lib()
    fn = getattr(L, "rnaelem_%s_%s" % (fname, _SUF[dtype]))
    dev = like.device.index
    with contextlib.nullcontext() if dev == torch.cuda.current_device() \
            else torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed: %s (%d)" % (
            fname, L.rnaelem_error_string(rc).decode(), rc))
    k = KERNELS[kernel]
    k.launches += 1
    if variant is not None:
        k.variants[variant] = k.variants.get(variant, 0) + 1


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _req(t, name, dtype, shape, device):
    if not torch.is_tensor(t) or t.device != device:
        raise ValueError("%s: expected a tensor on %s" % (name, device))
    if t.dtype != dtype:
        raise TypeError("%s: expected %s, got %s" % (name, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s: expected shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: must be contiguous" % name)


# ------------------------------------------------------- K1 score tables

SCORE_ROW_BYTES = 128    # a row of a block's reads in a float plane: a line
SCORE_DIAGONALS = (1,)   # J a block, 2^k - 1 (J + 1 staging lanes)
SCORE_MAX_GROUPS = 65535     # the grid's y: groups of reads


def score_smem_bytes(Wp, G, J):
    """K1's shared bytes (csrc/score_tables.cu score_smem): each diagonal's
    first pair and dots_cum as int32 [J][G], [J + Wp][G], the codes as
    bytes [J + Wp + 4][G], bp_ok's cells of J + 1 diagonals [J + 1][Wp +
    1][G]."""
    return 4 * G * (J + (J + Wp)) + G * (J + Wp + 4) + (J + 1) * (Wp + 1) * G


class ScorePlan(NamedTuple):
    """How K1 runs a shape: blocks of ``G`` reads (a power of two, a row
    of them a 128-byte line of a float plane) x ``J`` diagonals i = j -
    w, the grid ``bands`` x ``groups``, ``smem`` bytes of shared memory."""
    Lp: int
    Wp: int
    G: int
    J: int
    bands: int
    groups: int
    smem: int

    @property
    def name(self):
        return "G=%d,J=%d" % (self.G, self.J)

    @property
    def grid_args(self):
        return (self.G, self.G.bit_length() - 1, self.J,
                (self.J + 1).bit_length() - 1, self.bands, self.groups,
                self.smem)

    def window(self, band):
        """What block ``band`` stages (the kernel's own arithmetic): its
        diagonals i0 .. i0 + J - 1, the codes at positions lo .. hi, the
        dots_cum entries dlo .. dhi, and bp_ok's cells on the diagonals
        i0 - 1 .. i0 + J - 1 (rows 0 .. Lp)."""
        Lp, Wp, J = self.Lp, self.Wp, self.J
        i0 = -Wp + band * J
        clamp = lambda x, a, b: min(max(x, a), b)
        return dict(i0=i0, lo=clamp(i0 - 3, 0, Lp - 1),
                    hi=clamp(i0 + J + Wp, 0, Lp - 1), dlo=clamp(i0, 0, Lp),
                    dhi=clamp(i0 + J - 1 + Wp, 0, Lp))


@functools.lru_cache(maxsize=None)
def score_plan(Lp, Wp, B, dtype):
    """K1's plan: G = a line's worth of reads (32 at f32, 16 at f64; the
    least power of two >= B below that), J = SCORE_DIAGONALS[0] diagonals
    a block, fewer diagonals and then fewer reads where the shared bytes
    would pass SMEM_LIMIT.  ValueError where nothing fits."""
    it = torch.empty((), dtype=dtype).element_size()
    G = min(SCORE_ROW_BYTES // it, _pow2(B))
    while G >= 1:
        for J in SCORE_DIAGONALS:
            smem = score_smem_bytes(Wp, G, J)
            groups = -(-B // G)
            if smem <= SMEM_LIMIT and groups <= SCORE_MAX_GROUPS:
                return ScorePlan(Lp, Wp, G, J, -(-(Lp + Wp + 1) // J),
                                 groups, smem)
        G //= 2
    raise ValueError("score_tables: no block fits Lp=%d, Wp=%d, B=%d (%d "
                     "bytes of shared memory at one read and one diagonal, "
                     "at most %d)" % (Lp, Wp, B, score_smem_bytes(Wp, 1, 1),
                                      SMEM_LIMIT))


def score_tables(tab, seq, L, bp_ok, dots_cum, Wp: int, max_span: int,
                 turn: int, no_ene: bool, fix_rss: bool):
    """Launch K1 (csrc/score_tables.cu) on score_plan's layout; same
    outputs as energy.tables.score_tables_plain."""
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError("score_tables kernel: seq must be a CUDA tensor")
    packed = tab["packed"]
    dt = packed.dtype
    B, Lp = seq.shape
    _req(packed, "packed tables", dt, packed.shape, dev)
    _req(seq, "seq", torch.int64, (B, Lp), dev)
    _req(L, "L", torch.int64, (B,), dev)
    _req(bp_ok, "bp_ok", torch.bool, (B, Lp + 1, Wp + 1), dev)
    _req(dots_cum, "dots_cum", torch.int32, (B, Lp + 1), dev)
    offs = tab["packed_offsets"]
    if len(offs) != N_TABLES:
        raise ValueError("packed tables: expected %d offsets" % N_TABLES)
    plan = score_plan(Lp, Wp, B, dt)
    g = (Lp + 1, Wp + 1, B)
    e = lambda shape, t=dt: torch.empty(shape, dtype=t, device=dev)
    out = {k: e(g) for k in ("hp", "stk", "ext", "ml2", "mlE")}
    out.update(misA=e((4,) + g), misB=e((4,) + g), spec_il=e((6,) + g),
               t_out=e(g, torch.int32), t_in=e(g, torch.int32))
    out.update({k: e(g, torch.bool) for k in ("okP", "okE", "okM", "okB")})
    p = ScoreDims(Lp, Wp, B, max_span, turn, int(no_ene), int(fix_rss),
                  (ctypes.c_int * N_TABLES)(*offs))
    _call("score_tables", "score_tables", packed, p,
          ScoreGrid(*plan.grid_args), _p(packed), _p(seq), _p(L), _p(bp_ok),
          _p(dots_cum), *[_p(out[k]) for k in (
              "hp", "stk", "ext", "ml2", "mlE", "misA", "misB", "spec_il",
              "t_out", "t_in", "okP", "okE", "okM", "okB")],
          variant=plan.name)
    return out


# --------------------------------------------- K2-K4 column stage kernels

TABLE_KEYS = ("LL", "P", "E", "M", "Bt", "T1", "T2")


def _check_column(state, j, d, c, h, st):
    """Full input validation, once per (state, factors) combination.
    The kernels take one lambda [2] and one eSZg [2, 4, Cp+1, Cp+1] for
    the batch: the per-read copies (there for per-read gradients) must be
    equal, and their first column goes into state['_lam'] and
    state['_eSZg']."""
    key = (id(d), id(c), id(h), id(st))
    if _check_tables(state, j, d, c, st, key):
        return
    Lp, Wp, Cp = st.dims.Lp, st.dims.Wp, st.dims.Cp
    dt, dev = st.dtype, state["O"].device
    B = state["O"].shape[-1]
    R, W1, C1 = Lp + 1 + st.PAD, Wp + 1, Cp + 1
    _req(state["ep"], "ep", dt, (R, W1, st.dims.S, B), dev)
    _req(state["ep_shift"], "ep_shift", dt, (Lp + 1, 3, B), dev)
    for name, t, shape in (
            ("eSZg", h["eSZg"], (2, 4, C1, C1, B)),
            ("emisA", h["emisA"], (2, 4, Lp + 1, W1, B)),
            ("emisB", h["emisB"], (2, R, W1, 4, B))):
        _req(t, name, dt, shape, dev)
    state["_eSZg"] = h["eSZg"][..., 0].contiguous()
    state["_checked"] = key


def _check_tables(state, j, d, c, st, key):
    """The checks the sum DP's and the max DP's column stages share:
    tables, factors, constants, one lambda for the batch (into
    state['_lam']) and the aux.  True if ``key`` was checked already."""
    if not 1 <= j <= st.dims.Lp:
        raise ValueError("column %d outside 1..%d" % (j, st.dims.Lp))
    if state.get("_checked") == key:
        return True
    Lp, Wp, S = st.dims.Lp, st.dims.Wp, st.dims.S
    dt, dev = st.dtype, state["O"].device
    if dev.type != "cuda" or dt not in _SUF:
        raise ValueError("column kernels take float32/float64 CUDA tensors")
    B = state["O"].shape[-1]
    R, W1 = Lp + 1 + st.PAD, Wp + 1
    for k in TABLE_KEYS:
        _req(state[k], k, dt, (R, W1, S, B), dev)
    _req(state["O"], "O", dt, (R, S, B), dev)
    Tp = d.pv.shape[2]
    for name, t, shape in (
            ("eR", d.eR, (Lp, S, B)), ("eL", d.eL, (Lp, S, B)),
            ("bg2", d.bg2, (Lp, B)), ("pv", d.pv, (Lp + 1, W1, Tp, B)),
            ("alphaP", d.alphaP, (Lp + 1, W1, B)),
            ("wsp", c.wsp, (Lp, B)), ("gate_O2", c.gate_O2, (Lp, B)),
            ("gate_M", c.gate_M, (Lp, B)),
            ("spec_il", c.ep["spec_il"], (6, Lp + 1, W1, B))):
        _req(t, name, dt, shape, dev)
    for name in ("hp", "stk", "ext", "ml2", "mlE"):
        _req(getattr(c, name), name, dt, (Lp + 1, W1, B), dev)
    for name in ("okP", "okE", "okM", "okB"):
        _req(getattr(c, name), name, torch.bool, (Lp + 1, W1, B), dev)
    _req(c.C, "C", torch.int32, (B,), dev)
    _req(c.dots_cum, "dots_cum", torch.int32, (Lp + 1, B), dev)
    if d.lam.dtype != dt or tuple(d.lam.shape) != (2, B):
        raise ValueError("lam: expected %s [2, %d]" % (dt, B))
    # copies seen through a zero stride along the reads (per_read's views
    # of shared weights) are one value; others are compared on the device
    if d.lam.stride(1) != 0 and \
            not torch.equal(d.lam, d.lam[:, :1].expand_as(d.lam)):
        raise ValueError("the kernels take one lambda for the batch: "
                         "per-read copies must be equal")
    _check_aux(d, c, Lp, B, dt, dev)
    state["_lam"] = d.lam[:, 0].contiguous()
    return False


def _check_aux(d, c, Lp, B, dt, dev):
    """The scanner's aux as the kernels take it: a pin and a class probe,
    never dense factors."""
    if any(getattr(d, k) is not None for k in AUX):
        raise ValueError("the kernels take the scanner's aux as a pin and a "
                         "class probe, not dense factors")
    if d.cls is not None:
        _req(d.cls, "cls", dt, (4, Lp, B), dev)
        _req_zero_probe(d.cls)
    _check_pins(c.pin, B, dev)


def _check_pins(pin, B, dev):
    pins = pin_set(pin)
    if len(pins) > MAX_PINS:
        raise ValueError("the kernels take at most %d pins" % MAX_PINS)
    for p in pins:
        _req(p.pos, "pin", torch.int32, (B,), dev)


def _req_zero_probe(cls):
    """The kernels write the class sums at a zero probe: they never add
    the probe's values to the transitions, as the plain versions do.  A
    probe of ops/dp.zero_probe not written since is zeros; any other is
    counted on the device."""
    if getattr(cls, "_rnaelem_zero_version", None) == cls._version:
        return
    if torch.count_nonzero(cls).item():
        raise ValueError("the kernels take the class probe as zeros only")


def _aux(st, pin, parts=None):
    """Aux struct for a launch: class codes, the pin set ``pin`` (a
    dp.Pin, a tuple of them or None) and the class-partial buffers
    ``parts`` (cpR, cpL) or none."""
    cpR, cpL = (None, None) if parts is None else \
        (parts[0].data_ptr(), parts[1].data_ptr())
    pins = pin_set(pin)
    pad = lambda xs: list(xs) + [0] * (MAX_PINS - len(xs))
    return AuxArg(st.k["cls_code"].data_ptr(),
                  (ctypes.c_void_p * MAX_PINS)(
                      *pad([p.pos.data_ptr() for p in pins])),
                  (ctypes.c_int * MAX_PINS)(*pad([int(p.bit) for p in pins])),
                  (ctypes.c_int * MAX_PINS)(
                      *pad([int(p.kinds) for p in pins])), cpR, cpL)


def _dims(st, state, j, d):
    D = st.dims
    return DPDims(D.Lp, D.Wp, D.Cp, D.S, state["O"].shape[-1], st.PAD, j,
                  st.n13, st.n_ar, st.n2, st.n_cls, d.pv.shape[2],
                  int(D.fix_rss), int(D.no_ene), st.n_pt)


def _idx(st, cls, fields):
    """Index struct for ``cls``, cached on the static object (the tensors
    it points into live in st.k)."""
    cache = st.__dict__.setdefault("_cidx", {})
    if cls.__name__ not in cache:
        # lists a grammar lacks (no internal loops) are null pointers
        cache[cls.__name__] = cls(*[st.k[f].data_ptr() if f in st.k else 0
                                    for f in fields])
    return cache[cls.__name__]


def _band_idx(st):
    return _idx(st, BandIdx, BAND_IDX)


def band_front(state, j, d, c, h, st):
    """K2 stages L, P, T2 of column j (writes rows j of LL, P, T2)."""
    _check_column(state, j, d, c, h, st)
    _call("inside_band", "band_front", state["O"], _dims(st, state, j, d),
          _band_idx(st), _aux(st, c.pin), _p(state["LL"]), _p(state["P"]),
          _p(state["T2"]), _p(state["E"]), _p(d.eR), _p(d.bg2), _p(d.pv),
          _p(d.alphaP), _p(c.wsp), _p(state["_lam"]), _p(c.stk), _p(c.ml2),
          _p(c.gate_O2), _p(c.okP), _p(c.okB))


def band_bif(state, j, d, c, h, st):
    """K2 stages B and T1 of column j."""
    _check_column(state, j, d, c, h, st)
    _call("inside_band", "band_bif", state["O"], _dims(st, state, j, d),
          _band_idx(st), _p(state["Bt"]), _p(state["T1"]),
          _p(state["T2"]), _p(c.okB))


def band_m(state, j, d, c, h, st, plan=None):
    """K2 stage M (sequential multiloop chain) of column j, in blocks of
    ``plan`` (band_plan's for the grammar, unless given)."""
    plan = plan or band_plan("inside_band", st.dims.S, st.dtype)
    _check_column(state, j, d, c, h, st)
    _call("inside_band", "band_m", state["O"], _dims(st, state, j, d),
          _band_idx(st), _aux(st, c.pin), _p(state["M"]), _p(state["Bt"]),
          _p(d.eL), _p(c.gate_M), _p(c.okM), _mchain_ws(state, plan),
          plan.G, plan.R, plan.cells, variant=plan.name)


def band_e(state, j, d, c, h, st):
    """K2 stage E of column j (reads the K3 ep term)."""
    _check_column(state, j, d, c, h, st)
    _call("inside_band", "band_e", state["O"], _dims(st, state, j, d),
          _band_idx(st), _p(state["E"]), _p(state["LL"]), _p(state["M"]),
          _p(state["ep"][j + st.PAD]), _p(state["_lam"]), _p(c.hp), _p(c.mlE),
          _p(c.okE))


# ------------------------------------------------------- launch plans
#
# K3's, K6's and K11's fused blocks (csrc/ep_col.cuh) take one read and
# one of EP_XSPLIT (kEpXSplit) ranges of x per block, K3's and K6's
# partials EP_XSPLIT deep (K11's ranges follow the batch and the variant:
# rnaelem_ep_max_ranges).  The M chain's blocks (csrc/mchain.cuh) take a
# group of G reads, a cell per (state, read) and 1, 2 or 4 cells a thread,
# their inputs staged in a ring of R steps.  What a block keeps grows with the grammar (S, n_ar),
# the max internal loop Cp and the type, never with the span Wp or B:
# the plans below pick, from those alone and before any launch, the
# hand-written kernel's variant that takes the shape.
EP_XSPLIT = 4
SMEM_LIMIT = 232448      # dynamic shared memory a block may take (H100)
MAX_THREADS = 1024       # threads a block may take
EP_WS_ALIGN = 256        # a block's workspace slice starts on this boundary
BAND_GROUP_BYTES = 32    # a (w, s) row of an M-chain block's reads at most
BAND_RING = 4            # kMRing
BAND_RING_SMALL = 2      # kMRingSmall
BAND_MAX_CELLS = 4       # (state, read) cells a thread of the M chain


def ep_smem_bytes(kernel, S, n_ar, Cp, dtype):
    """Bytes of one block's layout of K3 (``kernel`` "inside_ep"), K6
    ("outside_ep") or K11 ("inside_ep_max"): EpFwdLayout, EpAdjLayout and
    EpMaxLayout of csrc/ep_col.cuh.  The span Wp does not enter: what a
    block keeps per width lives in a ring of Cp+1 rows."""
    it = torch.empty((), dtype=dtype).element_size()
    C1 = Cp + 1
    tri = C1 * (C1 + 1) // 2      # W, gW and GSZ live on dl + u1 <= Cp
    if kernel == "inside_ep":     # exP, exL3, mAB, T, W, V, out ring, and
        n = (2 * C1 * S + 16 * C1 + C1 * n_ar + 2 * tri + 2 * C1 * n_ar
             + C1 * S + 4 * 256)  # red [4][kEpThreads]
        return it * n
    if kernel == "outside_ep":    # doubles: mAB, T, W, V, gW, go ring,
        n_a = (16 * C1 + C1 * n_ar + 4 * tri + 2 * C1 * n_ar   # gL3, gmA
               + C1 * S + C1 * S + 8 * C1 + 8 * tri + 12)      # ring, gsz,
        return 8 * n_a + it * 2 * C1 * S   # glam; scalar: exP, exL3
    if kernel == "inside_ep_max":  # L3, two stages (P and LL cells, misA
        n = (C1 * S + 2 * (2 * C1 * S + 8 * C1 + 8)    # and misB, the
             + C1 * n_ar + 2 * tri + 2 * C1 * n_ar      # specials' il),
             + C1 * S)                                  # T, W, V, out ring
        return it * n
    raise ValueError("no fused block for kernel %r" % kernel)


class EpPlan(NamedTuple):
    """How K3, K6 or K11 runs a shape: ``variant`` "shared" (the block's
    layout in ``smem`` bytes of shared memory) or "device" (the same
    kernel body, the layout in a slice of ``block_bytes`` of a device
    workspace per block: csrc/ep_col.cuh ep_base)."""
    kernel: str
    variant: str
    smem: int
    block_bytes: int

    @property
    def name(self):
        return self.variant


@functools.lru_cache(maxsize=None)
def ep_plan(kernel, S, n_ar, Cp, dtype, variant=None):
    """The launch plan of K3 ("inside_ep"), K6 ("outside_ep") or K11
    ("inside_ep_max") for a grammar (S states, n_ar AR pairs), max
    internal loop Cp and type: the shared variant where its layout fits
    the SMEM_LIMIT bytes a block may take, else the device variant, whose
    blocks give the same bits.  ``variant`` forces one ("shared" raises
    ValueError where it does not fit)."""
    layout = ep_smem_bytes(kernel, S, n_ar, Cp, dtype)
    if variant is None:
        variant = "shared" if layout <= SMEM_LIMIT else "device"
    if variant == "shared":
        if layout > SMEM_LIMIT:
            raise ValueError(
                "%s: the shared variant's block needs %d bytes of shared "
                "memory (S=%d, n_ar=%d, Cp=%d, %s), more than %d"
                % (kernel, layout, S, n_ar, Cp,
                   str(dtype).replace("torch.", ""), SMEM_LIMIT))
        return EpPlan(kernel, "shared", layout, 0)
    if variant == "device":
        return EpPlan(kernel, "device", 0,
                      -(-layout // EP_WS_ALIGN) * EP_WS_ALIGN)
    raise ValueError("ep_plan: variant %r is neither 'shared' nor "
                     "'device'" % (variant,))


def band_smem_bytes(kernel, S, dtype, G, R=BAND_RING):
    """Dynamic shared memory of one M-chain block of K2's band_m (kernel
    "inside_band", K10's too) or K5's m_adj ("outside_band") in blocks of
    G reads with a ring of R stages: MLayout of csrc/mchain.cuh, two slots
    of the published row and the ring of the step's inputs with their okM
    words.  Neither the span Wp nor B enters."""
    it = torch.empty((), dtype=dtype).element_size()
    n = S * G
    nbuf, nring = {"inside_band": (2, 3), "outside_band": (2, 9)}[kernel]
    return 2 * nbuf * n * it + R * (nring * n * it + 4 * n)


class BandPlan(NamedTuple):
    """How the M chain of K2/K10 ("inside_band") or K5 ("outside_band")
    runs a grammar: blocks of G reads and ``threads`` threads (``cells``
    (state, read) cells a thread: 1, or 2 or 4 states strided at G = 1),
    a ring of R stages, ``smem`` bytes of shared memory; ``variant``
    "device" keeps the layout in a slice of ``block_bytes`` of a device
    workspace per block instead (smem 0)."""
    kernel: str
    G: int
    R: int
    threads: int
    smem: int
    cells: int = 1
    variant: str = "shared"
    block_bytes: int = 0

    @property
    def name(self):
        return "G=%d,R=%d" % (self.G, self.R) + (
            ",cells=%d" % self.cells if self.cells > 1 else "") + (
            ",device" if self.variant == "device" else "")


@functools.lru_cache(maxsize=None)
def band_plan(kernel, S, dtype, G=None, R=None, variant=None, cells=None):
    """The M chain's launch plan for S states at ``dtype``: the first of
    32 bytes' worth of reads per block (8 f32, 4 f64), 4, 2 and 1 whose
    block (S x G threads, the layout with a ring of BAND_RING stages, or
    of BAND_RING_SMALL at G = 1) fits a block.  Past MAX_THREADS states a
    block holds one read (G = 1) and a thread 2 or 4 states strided by
    the block's width (up to BAND_MAX_CELLS x MAX_THREADS states); where
    not even the G = 1 ring of BAND_RING_SMALL fits, the device variant
    keeps the layout (ring of BAND_RING) in a device workspace.  A read's
    results do not depend on G, R, the cells per thread or the variant.
    ``G``, ``R``, ``variant`` ("shared" or "device") and ``cells`` (1, 2
    or 4; more than 1 only at G = 1) force a group, a ring, a variant and
    the cells a thread, so that every build of the chain can be held
    against another at the same S (ValueError where the block does not
    fit; a group larger than 1 needs S x G <= MAX_THREADS)."""
    it = torch.empty((), dtype=dtype).element_size()
    groups = tuple(g for g in (8, 4, 2, 1) if g * it <= BAND_GROUP_BYTES)
    if G is not None:
        if G not in groups:
            raise ValueError("band_plan: G=%r is not one of %s at %s"
                             % (G, groups, dtype))
        groups = (G,)
    if variant not in (None, "shared", "device"):
        raise ValueError("band_plan: variant %r is neither 'shared' nor "
                         "'device'" % (variant,))
    if cells not in (None, 1, 2, BAND_MAX_CELLS):
        raise ValueError("band_plan: cells=%r is not one of (1, 2, %d)"
                         % (cells, BAND_MAX_CELLS))
    for g in groups:
        nc = 1
        while S * g > MAX_THREADS * nc and nc < BAND_MAX_CELLS:
            nc *= 2
        nc = nc if cells is None else cells
        if S * g > MAX_THREADS * nc or (nc > 1 and g > 1):
            continue
        per_thread_rows = -(-S * g // nc)
        threads = -(-per_thread_rows // 32) * 32
        rings = (BAND_RING, BAND_RING_SMALL) if g == 1 else (BAND_RING,)
        if R is not None:
            if R not in rings:
                raise ValueError("band_plan: R=%r is not one of %s at G=%d"
                                 % (R, rings, g))
            rings = (R,)
        if variant != "device":
            for r in rings:
                smem = band_smem_bytes(kernel, S, dtype, g, r)
                if smem <= SMEM_LIMIT:
                    return BandPlan(kernel, g, r, threads, smem, nc)
        if g == 1 and variant != "shared" and BAND_RING in rings:
            layout = band_smem_bytes(kernel, S, dtype, 1, BAND_RING)
            return BandPlan(kernel, 1, BAND_RING, threads, 0, nc,
                            "device",
                            -(-layout // EP_WS_ALIGN) * EP_WS_ALIGN)
    raise ValueError(
        "%s: no M-chain block takes %d states at %s%s%s (at most %d "
        "threads, a group of more than one read one state a thread, at "
        "most %d states a thread)"
        % (kernel, S, str(dtype).replace("torch.", ""),
           "" if G is None else " in groups of %d reads" % G,
           "" if cells is None else " at %d cells a thread" % cells,
           MAX_THREADS, BAND_MAX_CELLS))


def _workspace(scr, plan, blocks, dev):
    """The device variant's workspace (``blocks`` slices of the plan's
    block bytes), kept in the scratch dict ``scr`` and grown when a later
    call needs more; a null pointer for the shared variant."""
    if plan.variant != "device":
        return ctypes.c_void_p(None)
    need = blocks * plan.block_bytes
    ws = scr.get("ws")
    if ws is None or ws.numel() < need:
        ws = torch.empty(need, dtype=torch.uint8, device=dev)
        scr["ws"] = ws
    return _p(ws)


def _mchain_ws(state, plan):
    """The M chain's device workspace (a slice of the plan's block bytes
    per group of reads), kept in ``state`` (the inside tables or the
    gradient state: the chain of the outside pass runs beside K6 on its
    own stream), or a null pointer for the shared variant."""
    B = state["O"].shape[-1]
    scr = state.setdefault("_mchain_scratch", {})
    return _workspace(scr, plan, -(-B // plan.G), state["O"].device)


def ep_stage(state, j, d, c, h, st, plan=None):
    """K3: the TT_E_P internal-loop term of column j into row j of the
    ep table (two launches: the fused blocks, in ``plan``'s variant, then
    the sum of their partials).  The per-(column, read) shifts go into
    the state's ep_shift [Lp+1, 3, B], which K6 reads."""
    plan = plan or ep_plan("inside_ep", st.dims.S, st.n_ar, st.dims.Cp,
                           st.dtype)
    _check_column(state, j, d, c, h, st)
    if not st.have_ep:
        state["ep"][j + st.PAD].fill_(float("-inf"))
        return
    dt, dev = st.dtype, state["O"].device
    B = state["O"].shape[-1]
    W1, C1, S = st.dims.Wp + 1, st.dims.Cp + 1, st.dims.S
    scr = state.get("_ep_scratch")
    if scr is None:
        # per-row maxima of P and of LL up to width Cp, for the rows the
        # state holds now; the fused blocks add each new row as it is done
        rowmax = torch.stack([state["P"].amax(dim=(1, 2)),
                              state["LL"][:, :C1].amax(dim=(1, 2))])
        scr = dict(
            rowmax=rowmax.contiguous(),
            part=torch.empty((EP_XSPLIT, W1, S, B), dtype=dt, device=dev))
        state["_ep_scratch"] = scr
    D = _dims(st, state, j, d)
    ws = _workspace(scr, plan, B * EP_XSPLIT, dev)
    _call("inside_ep", "ep_fwd", state["O"], D, _idx(st, EpIdx, EP_IDX),
          _p(state["P"]), _p(state["LL"]), _p(h["emisA"]), _p(h["emisB"]),
          _p(state["_eSZg"]), _p(c.ep["spec_il"]), _p(state["_lam"]),
          _p(c.dots_cum), _p(c.C), _p(scr["rowmax"]), _p(state["ep_shift"]),
          _p(scr["part"]), ws, variant=plan.name)
    _call("inside_ep", "ep_fwd_red", state["O"], D, _p(scr["part"]),
          _p(state["ep_shift"]), _p(state["ep"]))


def ext_stage(state, j, d, c, h, st):
    """K4: the exterior O column j (writes row j of O)."""
    _check_column(state, j, d, c, h, st)
    ix = _idx(st, ExtIdx, EXT_IDX)
    _call("inside_ext", "ext_col", state["O"], _dims(st, state, j, d), ix,
          _aux(st, c.pin), _p(state["O"]), _p(state["P"]), _p(d.eR),
          _p(c.gate_O2), _p(c.ext), _p(state["_lam"]))


# ----------------------------------------- K5-K7 outside (adjoint) stages
#
# Each takes the inside tables ``fs`` of a CUDA forward and the gradient
# state ``gs`` of ops.dp.init_grads, and adds the cotangents of column j's
# stage inputs into gs, on the current stream (same signatures as the
# plain versions ops.dp.*_adj_plain).

def _check_adj(fs, gs, j, d, c, h, st):
    _check_column(fs, j, d, c, h, st)
    key = (id(fs), id(d), id(c), id(h), id(st))
    if gs.get("_checked") == key:
        return
    dev, dt = fs["O"].device, st.dtype
    for k in GRAD_TABLES:
        _req(gs[k], "grad " + k, dt, fs[k].shape, dev)
    col = fs["LL"].shape[1:]
    for k in ("gM", "gB", "gep"):
        _req(gs[k], "grad " + k, dt, col, dev)
    for k, ref in (("eR", d.eR), ("eL", d.eL), ("bg2", d.bg2),
                   ("pv", d.pv), ("alphaP", d.alphaP),
                   ("emisA", h["emisA"]), ("emisB", h["emisB"])):
        _req(gs[k], "grad " + k, dt, ref.shape, dev)
    _req(gs["DL"], "grad DL", dt, fs["LL"][: st.dims.Lp + 1].shape, dev)
    _req(gs["GSZ"], "grad GSZ", dt, h["eSZg"].shape, dev)
    _req(gs["lam"], "grad lam", dt, (2, fs["O"].shape[-1]), dev)
    if d.cls is not None:
        _req(gs["cls"], "grad cls", dt, d.cls.shape, dev)
    gs["_checked"] = key


def _adj_scratch(gs, st, B, dev):
    scr = gs.get("_adj_scratch")
    if scr is None:
        W1, C1, S, dt = st.dims.Wp + 1, st.dims.Cp + 1, st.dims.S, st.dtype
        e = lambda *shape: torch.empty(shape, dtype=dt, device=dev)
        # done: front_adj_sw's count of finished blocks (its last block
        # resets it), kept on st across passes as K15's and K17's
        scr = dict(ePart=e(W1, S, B), bgp=e(W1, B),
                   done=_done(st, "front_adj_sw", dev, 1))
        if st.have_ep:
            # K6's blocks' partials of the sums across x (right flank,
            # emisA row j, the size weights' triangle dl + u1 <= Cp,
            # lambda's small-loop term per (bucket, special))
            scr.update(gL3p=e(EP_XSPLIT, C1, S, B),
                       gmAp=e(EP_XSPLIT, 8, W1, B),
                       gszp=e(EP_XSPLIT, 8, C1 * (C1 + 1) // 2, B),
                       glamp=e(EP_XSPLIT, 2, 6, B))
        gs["_adj_scratch"] = scr
    return scr


def _cls_parts(gs, st, B, dev):
    """The class-partial buffers (cpR, cpL) [4, Wp+1, S, B] of the
    outside pass (zero; cls_red zeroes what it sums), or None without a
    class probe."""
    if "cls" not in gs:
        return None
    if "_cls_parts" not in gs:
        shape = (4, st.dims.Wp + 1, st.dims.S, B)
        gs["_cls_parts"] = tuple(torch.zeros(shape, dtype=st.dtype,
                                             device=dev) for _ in range(2))
    return gs["_cls_parts"]


EXT_ADJ_LISTS = ("opa", "opc", "op", "rtr", "rt")


def ext_adj_lists(st):
    """K7's lists per state s (csrc/outside_ext.cu ExtAdjLists), built
    once per DPStatic on the host from its CSR lists: int32 rows [S,
    stride] of the lists' lengths at s, bucket[s] and the lists padded to
    the longest (nA, nC, nO, nR, nT), scalar rows [S, nR + nT] of the
    chain's weights, and those five widths."""
    got = st.__dict__.get("_ext_adj_lists")
    if got is not None:
        return got
    k = {n: st.k[n].cpu().numpy() for n in (
        "opa_off", "opa_t", "opa_c", "opc_off", "opc_t", "opc_a", "op_off",
        "op_a", "op_c", "rtr_off", "rtr_t", "rtr_w", "rt_off", "rt_s",
        "rt_w", "bucket", "cls_code")}
    S = st.dims.S
    lens = np.stack([np.diff(k[n + "_off"]) for n in EXT_ADJ_LISTS], 1)
    caps = [max(1, int(v)) for v in lens.max(0)]
    nA, nC, nO, nR, nT = caps
    code, bu = k["cls_code"][0], k["bucket"]   # kind R: code[t, s], t <- s
    idx = np.zeros((S, 6 + 3 * nA + 3 * nC + 2 * nO + 2 * nR + 2 * nT),
                   np.int32)
    wt = np.zeros((S, nR + nT))
    for s in range(S):
        seg = {n: slice(k[n + "_off"][s], k[n + "_off"][s + 1])
               for n in EXT_ADJ_LISTS}
        ta, ca = k["opa_t"][seg["opa"]], k["opa_c"][seg["opa"]]
        tc, ac = k["opc_t"][seg["opc"]], k["opc_a"][seg["opc"]]
        tr, ur = k["rtr_t"][seg["rtr"]], k["rt_s"][seg["rt"]]
        cols = ((ta, nA), (ca, nA), (bu[ta], nA), (tc, nC), (ac, nC),
                (bu[tc], nC), (k["op_a"][seg["op"]], nO),
                (k["op_c"][seg["op"]], nO), (tr, nR), (code[tr, s], nR),
                (ur, nT), (code[s, ur], nT))
        idx[s, :6] = list(lens[s]) + [bu[s]]
        o = 6
        for v, n in cols:
            idx[s, o:o + len(v)] = v
            o += n
        wt[s, :len(tr)] = k["rtr_w"][seg["rtr"]]
        wt[s, nR:nR + len(ur)] = k["rt_w"][seg["rt"]]
    got = (torch.as_tensor(idx, device=st.device),
           torch.as_tensor(wt, dtype=st.dtype, device=st.device), tuple(caps))
    st._ext_adj_lists = got
    return got


def ext_adj(fs, gs, j, d, c, h, st):
    """K7: adjoint of the O column j (one launch)."""
    _check_adj(fs, gs, j, d, c, h, st)
    idx, wt, caps = ext_adj_lists(st)
    ax = _aux(st, c.pin,
              _cls_parts(gs, st, fs["O"].shape[-1], fs["O"].device))
    _call("outside_ext", "ext_adj", fs["O"], _dims(st, fs, j, d),
          ExtAdjListsArg(idx.data_ptr(), wt.data_ptr(), *caps), ax,
          _p(fs["O"]), _p(fs["P"]), _p(d.eR), _p(c.gate_O2), _p(c.ext),
          _p(fs["_lam"]), _p(gs["O"]), _p(gs["P"]), _p(gs["eR"]),
          _p(gs["DL"]))


def e_adj(fs, gs, j, d, c, h, st):
    """K5: adjoint of E at column j (fills gs['gM'] and gs['gep'])."""
    _check_adj(fs, gs, j, d, c, h, st)
    D, ix = _dims(st, fs, j, d), _idx(st, AdjIdx, ADJ_IDX)
    _call("outside_band", "e_adj", fs["O"], D, ix, _p(fs["E"]), _p(fs["LL"]),
          _p(fs["M"]), _p(fs["ep"]), _p(fs["_lam"]), _p(c.hp), _p(c.mlE),
          _p(gs["E"]), _p(gs["LL"]), _p(gs["gM"]), _p(gs["gep"]),
          _p(gs["DL"]))


def ep_adj(fs, gs, j, d, c, h, st, plan=None):
    """K6: adjoint of the internal-loop term at column j (two launches:
    the fused blocks, in ``plan``'s variant, which form K3's chain
    themselves from the shifts K3 kept in fs['ep_shift'], then the sum of
    their partials)."""
    plan = plan or ep_plan("outside_ep", st.dims.S, st.n_ar, st.dims.Cp,
                           st.dtype)
    _check_adj(fs, gs, j, d, c, h, st)
    if not st.have_ep:
        return
    B, dev = fs["O"].shape[-1], fs["O"].device
    scr = _adj_scratch(gs, st, B, dev)
    D = _dims(st, fs, j, d)
    ws = _workspace(scr, plan, B * EP_XSPLIT, dev)
    _call("outside_ep", "ep_adj", fs["O"], D, _idx(st, EpIdx, EP_IDX),
          _p(fs["P"]), _p(fs["LL"]), _p(fs["ep"]), _p(gs["gep"]), _p(fs["ep_shift"]),
          _p(h["emisA"]), _p(h["emisB"]), _p(fs["_eSZg"]),
          _p(c.ep["spec_il"]), _p(fs["_lam"]), _p(c.dots_cum), _p(c.C),
          _p(gs["P"]), _p(gs["LL"]), _p(gs["emisB"]), _p(scr["gL3p"]),
          _p(scr["gmAp"]), _p(scr["gszp"]), _p(scr["glamp"]), ws,
          variant=plan.name)
    _call("outside_ep", "ep_adj_red", fs["O"], D, _p(scr["gL3p"]),
          _p(scr["gmAp"]), _p(scr["gszp"]), _p(scr["glamp"]), _p(gs["LL"]),
          _p(gs["emisA"]), _p(gs["GSZ"]), _p(gs["lam"]))


def band_adj(fs, gs, j, d, c, h, st, plan=None):
    """K5: adjoint of M, B/T1 and L/P/T2 at column j in four launches (and,
    with a class probe, the column's class sums in a fifth): m_adj_stage
    (in ``plan``'s blocks), then band_adj_tail."""
    m_adj_stage(fs, gs, j, d, c, h, st, plan)
    band_adj_tail(fs, gs, j, d, c, h, st)


def m_adj_stage(fs, gs, j, d, c, h, st, plan=None):
    """K5's M chain at column j (with T1's share of B's cotangent), in
    blocks of ``plan`` (band_plan's for the grammar, unless given): it
    needs only e_adj's gM, so the outside pass may run it beside K6."""
    plan = plan or band_plan("outside_band", st.dims.S, st.dtype)
    _check_adj(fs, gs, j, d, c, h, st)
    D, ix = _dims(st, fs, j, d), _idx(st, AdjIdx, ADJ_IDX)
    ax = _aux(st, c.pin,
              _cls_parts(gs, st, fs["O"].shape[-1], fs["O"].device))
    f, g = fs, gs
    _call("outside_band", "m_adj", fs["O"], D, ix, ax, _p(f["M"]), _p(f["Bt"]),
          _p(d.eL), _p(c.gate_M), _p(c.okM), _p(g["gM"]), _p(f["T1"]),
          _p(g["T1"]), _p(g["gB"]), _p(g["eL"]), _mchain_ws(gs, plan),
          plan.G, plan.R, plan.cells, variant=plan.name)


def band_adj_tail(fs, gs, j, d, c, h, st):
    """The rest of K5 at column j after m_adj_stage: B's splits, the
    front, the column's sums (and the class sums)."""
    _check_adj(fs, gs, j, d, c, h, st)
    D, ix = _dims(st, fs, j, d), _idx(st, AdjIdx, ADJ_IDX)
    scr = _adj_scratch(gs, st, fs["O"].shape[-1], fs["O"].device)
    parts = _cls_parts(gs, st, fs["O"].shape[-1], fs["O"].device)
    ax = _aux(st, c.pin, parts)
    f, g = fs, gs
    _call("outside_band", "bif_adj", fs["O"], D, ix, _p(f["T1"]),
          _p(f["T2"]), _p(f["Bt"]), _p(g["gB"]), _p(g["T1"]), _p(g["T2"]))
    _call("outside_band", "front_adj_t", fs["O"], D, ix, ax, _p(f["LL"]),
          _p(f["P"]),
          _p(f["T2"]), _p(d.eR), _p(d.bg2), _p(d.pv), _p(d.alphaP),
          _p(c.wsp), _p(fs["_lam"]), _p(c.stk), _p(c.ml2), _p(c.gate_O2),
          _p(f["T1"]), _p(g["T1"]), _p(g["LL"]), _p(g["P"]), _p(g["T2"]),
          _p(g["DL"]), _p(scr["ePart"]))
    _call("outside_band", "front_adj_sw", fs["O"], D, ix, ax, _p(f["LL"]),
          _p(f["P"]), _p(f["T2"]), _p(f["E"]), _p(d.eR), _p(d.bg2),
          _p(d.pv), _p(d.alphaP), _p(c.wsp), _p(fs["_lam"]), _p(c.stk),
          _p(c.gate_O2), _p(g["LL"]), _p(g["P"]), _p(g["T2"]), _p(g["E"]),
          _p(g["pv"]), _p(g["alphaP"]), _p(scr["bgp"]), _p(scr["ePart"]),
          _p(g["eR"]), _p(g["bg2"]), _p(scr["done"]))
    if parts is not None:
        _call("outside_band", "cls_red", fs["O"], D, ax, _p(g["cls"]))


# ------------------------------------------------ K8-K9 no-rss chain
#
# A chain block holds one read, a cell per state (csrc/chain.cuh): one
# warp at S <= 32; past MAX_THREADS states a thread owns 2 or 4 states.
# K8 stages eR in a ring of CHAIN_RING steps; K9's block holds copies of
# its walkers (up to CHAIN_ADJ_THREADS threads) that share the work of a
# tile other than the walk; K9 takes the read in tiles of R steps whose
# layout (the tile's weights, cotangent rows, chain rows and eR rows) lies
# in shared memory, or, where not even one step fits, in a slice of a
# device workspace per block (tiles of CHAIN_DEV_TILE steps).
CHAIN_RING = 4           # kChainRing
CHAIN_MAX_STATES = 4096  # kChainMaxStates
CHAIN_DEV_TILE = 8       # K9's steps a tile in the device variant
CHAIN_ADJ_THREADS = 128  # kChainAdjThreads: K9's walkers and helpers
CHAIN_KERNELS = ("linear_fwd", "linear_adj")


def chain_smem_bytes(kernel, S, dtype, R=CHAIN_RING, nnz=0, aux=False):
    """Bytes of one chain block's layout (csrc/chain.cuh ChainFwdLayout,
    ChainAdjLayout): K8 ("linear_fwd") the chain row's two slots and the
    ring of eR rows; K9 ("linear_adj") a tile of R steps: the weights [R,
    nnz], the cotangent and chain rows [R + 1, S], eR's rows [R, S] and,
    in the pin / class-sum instantiation (``aux``), the cells' class
    partials [R, 4, S].  Neither Lp nor B enters."""
    it = torch.empty((), dtype=dtype).element_size()
    if kernel == "linear_fwd":
        return it * (2 + CHAIN_RING) * S
    if kernel == "linear_adj":
        return it * (R * nnz + 2 * (R + 1) * S + R * S
                     + (4 * R * S if aux else 0))
    raise ValueError("no chain block for kernel %r" % (kernel,))


class ChainPlan(NamedTuple):
    """How K8 ("linear_fwd") or K9 ("linear_adj") runs a shape: one read
    a block of ``threads`` threads, the first ``walkers`` of them owning
    ``cells`` states each (K9's other threads, copies of the walkers,
    share its staging, weights and class sums, not its walk), ``R`` steps
    (K8: its ring; K9: a tile), ``nnz`` transitions, ``smem`` bytes of
    shared memory; ``variant`` "device" keeps K9's layout in a slice of
    ``block_bytes`` of a device workspace per block instead (smem 0).
    ``aux``: the kernel's pin / class-sum instantiation."""
    kernel: str
    cells: int
    R: int
    nnz: int
    walkers: int
    threads: int
    smem: int
    variant: str = "shared"
    block_bytes: int = 0
    aux: bool = False

    @property
    def name(self):
        return "cells=%d" % self.cells + (
            ",R=%d" % self.R if self.kernel == "linear_adj" else "") + (
            ",device" if self.variant == "device" else "") + (
            ",aux" if self.aux else "")

    @property
    def grid_args(self):
        return (self.cells, self.R, self.nnz, self.threads,
                int(self.variant == "device"), self.smem, self.block_bytes)


@functools.lru_cache(maxsize=None)
def chain_plan(kernel, S, Lp, B, dtype, aux=False, nnz=0, variant=None):
    """The launch plan of K8 ("linear_fwd") or K9 ("linear_adj") for S
    states, Lp bases, B reads at ``dtype``; ``aux`` the pin / class-sum
    instantiation, ``nnz`` the grammar's transitions (K9's weights take
    nnz a step).  Lp bounds K9's tile; B enters no choice.  One read a
    block (its walk one warp where S <= 32, K9 with helpers up to
    CHAIN_ADJ_THREADS); past MAX_THREADS states 2 or 4 states a thread
    (to CHAIN_MAX_STATES, else ValueError).  K8 rings CHAIN_RING steps of
    eR; K9 takes the longest tile of steps (at most Lp) whose layout fits
    SMEM_LIMIT, else the device variant (tiles of CHAIN_DEV_TILE steps in
    a workspace slice per block).  ``variant`` ("shared" or "device", K9
    only) forces the layout's place; a read's bits do not depend on it."""
    if kernel not in CHAIN_KERNELS:
        raise ValueError("no chain block for kernel %r" % (kernel,))
    if not 1 <= S <= CHAIN_MAX_STATES:
        raise ValueError("%s: no chain block takes %d states (at most %d)"
                         % (kernel, S, CHAIN_MAX_STATES))
    if variant not in (None, "shared", "device") or (
            variant == "device" and kernel == "linear_fwd"):
        raise ValueError("chain_plan: variant %r is not one of %s's"
                         % (variant, kernel))
    nc = 1
    while S > MAX_THREADS * nc:
        nc *= 2
    per_thread = -(-S // nc)
    walkers = -(-per_thread // 32) * 32
    aux = bool(aux)
    if kernel == "linear_fwd":
        return ChainPlan(kernel, nc, CHAIN_RING, 0, walkers, walkers,
                         chain_smem_bytes(kernel, S, dtype), aux=aux)
    nnz = int(nnz)
    threads = CHAIN_ADJ_THREADS // walkers * walkers \
        if walkers < CHAIN_ADJ_THREADS else walkers
    fixed = chain_smem_bytes(kernel, S, dtype, 0, nnz, aux)
    step = chain_smem_bytes(kernel, S, dtype, 1, nnz, aux) - fixed
    R = min(max(Lp, 1), (SMEM_LIMIT - fixed) // step)
    if R >= 1 and variant != "device":
        return ChainPlan(kernel, nc, R, nnz, walkers, threads,
                         chain_smem_bytes(kernel, S, dtype, R, nnz, aux),
                         aux=aux)
    if variant == "shared":
        raise ValueError("%s: no tile of %d states fits %d bytes of shared "
                         "memory at %s" % (kernel, S, SMEM_LIMIT,
                                           str(dtype).replace("torch.", "")))
    R = min(max(Lp, 1), CHAIN_DEV_TILE)
    layout = chain_smem_bytes(kernel, S, dtype, R, nnz, aux)
    return ChainPlan(kernel, nc, R, nnz, walkers, threads, 0, "device",
                     -(-layout // EP_WS_ALIGN) * EP_WS_ALIGN, aux)


def _check_chain(st, eR, L, pin):
    dev = eR.device
    if dev.type != "cuda" or st.dtype not in _SUF:
        raise ValueError("chain kernels take float32/float64 CUDA tensors")
    Lp, S, B = eR.shape
    if S != st.dims.S or B < 1:
        raise ValueError("eR: expected [Lp, %d, B>=1], got %s"
                         % (st.dims.S, tuple(eR.shape)))
    _req(eR, "eR", st.dtype, (Lp, S, B), dev)
    _req(L, "L", torch.int64, (B,), dev)
    _check_pins(pin, B, dev)
    return ChainDims(Lp, S, B), _idx(st, ChainIdx, CHAIN_IDX)


def _chain_plan_for(kernel, st, D, aux, plan):
    """The plan of a launch: chain_plan's for the shape, or the caller's
    (forced), which must be the kernel's and the instantiation's."""
    nnz = int(st.k["rtr_t"].numel())
    if plan is None:
        return chain_plan(kernel, D.S, D.Lp, D.B, st.dtype, aux, nnz)
    if plan.kernel != kernel or plan.aux != aux or (
            kernel == "linear_adj" and plan.nnz != nnz):
        raise ValueError("%s: plan %s is not this launch's (aux=%s, nnz=%d)"
                         % (kernel, plan.name, aux, nnz))
    return plan


def chain_fwd(st, eR, L, pin=None, plan=None):
    """K8 on the grammar's DPStatic ``st``: ([B, 3] parts, the chain rows
    [Lp+1, S, B] for K9); rows beyond a read's length are left
    unwritten.  ``pin``: the scanner's dp.Pin or None; ``plan``: a
    chain_plan to force (else the shape's)."""
    D, ix = _check_chain(st, eR, L, pin)
    plan = _chain_plan_for("linear_fwd", st, D, bool(pin_set(pin)), plan)
    parts = torch.empty((D.B, 3), dtype=eR.dtype, device=eR.device)
    rows = torch.empty((D.Lp + 1, D.S, D.B), dtype=eR.dtype,
                       device=eR.device)
    _call("linear_fwd", "chain_fwd", eR, D, ix, _aux(st, pin),
          ChainGrid(*plan.grid_args), _p(eR), _p(L), _p(rows), _p(parts),
          variant=plan.name)
    return parts, rows


def chain_adj(st, eR, L, rows, gparts, pin=None, cls=None, plan=None):
    """K9: the cotangent of eR [Lp, S, B] from that of the parts [B, 3];
    with ``cls`` [4, Lp, B] it also writes there the class sums of the
    transition posteriors per base (the scanner's class probe).
    ``plan``: a chain_plan to force (else the shape's)."""
    D, ix = _check_chain(st, eR, L, pin)
    _req(rows, "chain rows", st.dtype, (D.Lp + 1, D.S, D.B), eR.device)
    _req(gparts, "parts cotangent", st.dtype, (D.B, 3), eR.device)
    if cls is not None:
        _req(cls, "class sums", st.dtype, (4, D.Lp, D.B), eR.device)
    plan = _chain_plan_for("linear_adj", st, D,
                           bool(pin_set(pin)) or cls is not None, plan)
    g_eR = torch.empty_like(eR)
    ax = _aux(st, pin)
    if cls is not None:
        ax.cpR = cls.data_ptr()
    ws = _workspace(st.__dict__.setdefault("_chain_scratch", {}), plan,
                    D.B, eR.device)
    _call("linear_adj", "chain_adj", eR, D, ix, ax,
          ChainGrid(*plan.grid_args), _p(eR), _p(L), _p(rows), _p(gparts),
          _p(g_eR), ws, variant=plan.name)
    return g_eR


# ------------------------------------- K10-K12 the CYK tables (max DP)
#
# The max-semiring instantiations of K2-K4 (ops/dp_maxb.py, same stage
# signatures with the MaxStatic ``mst`` for the sum DP's ``h`` and ``st``).

def _check_max_column(state, j, d, c, mst):
    """K10-K12's inputs: those of K2-K4 without the hoisted exponentials,
    plus the log mismatch tables and the size classes' log energies."""
    st = mst.st
    key = (id(d), id(c), id(mst))
    if _check_tables(state, j, d, c, st, key):
        return
    Lp, W1, C1 = st.dims.Lp, st.dims.Wp + 1, st.dims.Cp + 1
    dt, dev = st.dtype, state["O"].device
    B = state["O"].shape[-1]
    _req(state["ep"], "ep", dt, (Lp + 1 + st.PAD, W1, st.dims.S, B), dev)
    for name in ("misA", "misB"):
        _req(c.ep[name], name, dt, (4, Lp + 1, W1, B), dev)
    _req(mst.SZg, "SZ", dt, (4, C1, C1), dev)
    if bool((state["_lam"] < 0).any()):
        raise ValueError("the CYK tables need lambda >= 0")
    state["_checked"] = key


def max_band_front(state, j, d, c, mst):
    """K10 stages L, P, T2 of column j."""
    _check_max_column(state, j, d, c, mst)
    st = mst.st
    _call("inside_band_max", "band_front_max", state["O"],
          _dims(st, state, j, d), _band_idx(st), _aux(st, c.pin),
          _p(state["LL"]), _p(state["P"]), _p(state["T2"]), _p(state["E"]),
          _p(d.eR), _p(d.bg2), _p(d.pv), _p(d.alphaP), _p(c.wsp),
          _p(state["_lam"]), _p(c.stk), _p(c.ml2), _p(c.gate_O2), _p(c.okP),
          _p(c.okB))


def max_band_bif(state, j, d, c, mst):
    """K10 stages B and T1 of column j."""
    _check_max_column(state, j, d, c, mst)
    st = mst.st
    _call("inside_band_max", "band_bif_max", state["O"],
          _dims(st, state, j, d), _band_idx(st), _p(state["Bt"]),
          _p(state["T1"]), _p(state["T2"]), _p(c.okB))


def max_band_m(state, j, d, c, mst, plan=None):
    """K10 stage M of column j, in blocks of ``plan`` (band_plan's for
    the grammar, unless given)."""
    st = mst.st
    plan = plan or band_plan("inside_band", st.dims.S, st.dtype)
    _check_max_column(state, j, d, c, mst)
    _call("inside_band_max", "band_m_max", state["O"], _dims(st, state, j, d),
          _band_idx(st), _aux(st, c.pin), _p(state["M"]), _p(state["Bt"]),
          _p(d.eL), _p(c.gate_M), _p(c.okM), _mchain_ws(state, plan),
          plan.G, plan.R, plan.cells, variant=plan.name)


def max_band_e(state, j, d, c, mst):
    """K10 stage E of column j (reads the K11 ep term)."""
    _check_max_column(state, j, d, c, mst)
    st = mst.st
    _call("inside_band_max", "band_e_max", state["O"], _dims(st, state, j, d),
          _band_idx(st), _p(state["E"]), _p(state["LL"]), _p(state["M"]),
          _p(state["ep"][j + st.PAD]), _p(state["_lam"]), _p(c.hp),
          _p(c.mlE), _p(c.okE))


def max_ep_stage(state, j, d, c, mst, plan=None):
    """K11: the TT_E_P internal-loop maximum of column j into row j of
    the ep table (log space: no shifts), one launch: the fused blocks
    (one read and one range of x each, in ``plan``'s variant), the last
    block of a read merging the ranges' partial rows."""
    st = mst.st
    plan = plan or ep_plan("inside_ep_max", st.dims.S, st.n_ar, st.dims.Cp,
                           st.dtype)
    _check_max_column(state, j, d, c, mst)
    ep_row = state["ep"][j + st.PAD]
    if not st.have_ep:
        ep_row.fill_(float("-inf"))
        return
    D = _dims(st, state, j, d)
    B, dev = state["O"].shape[-1], state["O"].device
    scr = state.get("_ep_max_scratch")
    if scr is None or scr["variant"] != plan.variant:
        # the ranges' partial rows (W1 + n * Cp of them: csrc/ep_col.cuh
        # EpMaxRanges; n follows B and the variant) and each read's count
        # of finished blocks
        with torch.cuda.device(dev):
            n = int(lib().rnaelem_ep_max_ranges(
                D, torch.empty((), dtype=st.dtype).element_size(),
                int(plan.variant == "device")))
        rows = st.dims.Wp + 1 + n * st.dims.Cp
        scr = dict(part=torch.empty((rows, st.dims.S, B), dtype=st.dtype,
                                    device=dev),
                   done=torch.zeros(B, dtype=torch.int32, device=dev),
                   ranges=n, variant=plan.variant)
        state["_ep_max_scratch"] = scr
    ws = _workspace(scr, plan, B * scr["ranges"], dev)
    _call("inside_ep_max", "ep_max", state["O"], D,
          _idx(st, EpIdx, EP_IDX), _p(state["P"]), _p(state["LL"]),
          _p(c.ep["misA"]), _p(c.ep["misB"]), _p(mst.SZg),
          _p(c.ep["spec_il"]), _p(state["_lam"]), _p(c.dots_cum), _p(c.C),
          _p(scr["part"]), _p(scr["done"]), _p(ep_row), ws,
          variant=plan.name)


def max_ext_stage(state, j, d, c, mst):
    """K12: the exterior O column j of the CYK tables."""
    _check_max_column(state, j, d, c, mst)
    st = mst.st
    _call("inside_ext_max", "ext_col_max", state["O"], _dims(st, state, j, d),
          _idx(st, ExtIdx, EXT_IDX), _aux(st, c.pin), _p(state["O"]),
          _p(state["P"]), _p(d.eR), _p(c.gate_O2), _p(c.ext),
          _p(state["_lam"]))


# ------------------------------------------------ K13 the CYK traceback

TB_WARPS = 4             # warps a block (one block per read)
TB_MAX_WARPS = 8         # kTbMaxWarps
# the walk's trace per read (kTbTrace counters, csrc/cyk_traceback.cu)
TB_TRACE = ("cells_warp", "cells_block", "rounds_block", "slots",
            "cycles_warp", "cycles_block", "cycles_total")


def tb_pack(pt_code, pt_wl, pt_wr):
    """K13's packed pair transitions ((code + 2) << 2) | (wl << 1) | wr."""
    return ((np.asarray(pt_code, np.int64) + 2) << 2
            | np.asarray(pt_wl, np.int64) << 1
            | np.asarray(pt_wr, np.int64)).astype(np.int32)


def tb_lists(mst):
    """K13's lists on the MaxStatic ``mst``'s device, built once and kept
    on it: (TbLists, the int32 buffer, the scalar buffer)."""
    got = mst.__dict__.get("_tb_lists")
    if got is not None:
        return got
    st = mst.st
    kk = {n: v.detach().cpu().numpy() for n, v in dict(st.k, **mst.k).items()
          if n in TB_INT_LISTS + TB_SCALAR_LISTS + ("pt_code", "pt_wl",
                                                     "pt_wr")}
    kk["pt"] = tb_pack(kk["pt_code"], kk["pt_wl"], kk["pt_wr"])
    off, parts, n = {}, [], 0
    for name in TB_INT_LISTS:
        a = np.asarray(kk[name], np.int32).ravel()
        off[name], n = n, n + a.size
        parts.append(a)
    iv = torch.as_tensor(np.concatenate(parts), device=st.device)
    tparts, nt = [], 0
    for name in TB_SCALAR_LISTS:
        a = np.asarray(kk[name]).ravel()
        off[name], nt = nt, nt + a.size
        tparts.append(a)
    tv = torch.as_tensor(np.concatenate(tparts), dtype=st.dtype,
                         device=st.device)
    li = TbLists(iv.data_ptr(), tv.data_ptr(), iv.numel(), tv.numel(),
                 *[off[f] for f in TB_INT_LISTS + TB_SCALAR_LISTS])
    got = mst._tb_lists = (li, iv, tv)
    return got


def tb_smem_bytes(Lp, dtype, n_lists, stack, lists):
    """K13's dynamic shared bytes (csrc/cyk_traceback.cu tb_smem_bytes):
    the stack of 3 (Lp + 2) + 8 int4 cells where ``stack`` is shared, the
    lists (``n_lists`` = int32 and scalar lengths) where ``lists`` is
    shared, and the read's running dot counts, Lp + 1 ints."""
    it = torch.empty((), dtype=dtype).element_size()
    ni, nt = n_lists
    return (16 * tb_cap(Lp) if stack else 0) + (
        it * nt + 4 * ni if lists else 0) + 4 * (Lp + 1)


def tb_rows_fit(Lp, Wp, PAD, S, Tp):
    """K13's 32-bit row indices (csrc/cyk_traceback.cu tb_rows_fit): the
    tables [Lp+1+PAD, Wp+1, S] and pv, spec_il, misA, misB [<= max(Tp, 6),
    Lp+1, Wp+1] hold fewer than 2^31 rows of B values."""
    return (Lp + 1 + PAD) * (Wp + 1) * S < 2 ** 31 \
        and (Lp + 1) * (Wp + 1) * max(Tp, 6) < 2 ** 31


def tb_cap(Lp):
    """The walk's stack: cells per read."""
    return 3 * (Lp + 2) + 8


class TracebackPlan(NamedTuple):
    """How K13 runs a shape: one block of ``NW`` warps per read, the walk's
    stack (``cap`` cells) in shared memory or a device scratch
    (``stack``), the grammar's lists staged in shared memory or read where
    they lie (``lists``), ``smem`` bytes of dynamic shared memory; for Lp
    bases, ``n_lists`` (int32, scalar) list lengths at ``itemsize``."""
    Lp: int
    itemsize: int
    n_lists: tuple
    NW: int
    cap: int
    stack: str
    lists: str
    smem: int

    @property
    def name(self):
        return "NW=%d,stack=%s,lists=%s" % (self.NW, self.stack, self.lists)

    @property
    def grid_args(self):
        return (self.NW, int(self.stack == "shared"),
                int(self.lists == "shared"), self.smem)


@functools.lru_cache(maxsize=None)
def traceback_plan(Lp, dtype, n_lists, variant=None, warps=None):
    """K13's plan for reads of Lp bases at ``dtype`` with grammar lists of
    ``n_lists`` = (int32, scalar) lengths (tb_lists): TB_WARPS warps a
    block (``warps``: 1 to TB_MAX_WARPS to force); the lists in shared
    memory where they fit SMEM_LIMIT beside the dot counts, the stack
    there too where it fits beside them, else in the device scratch.
    ``variant`` "shared" or "device" forces the stack's place (ValueError
    where a shared stack does not fit); a read's outputs do not depend on
    the plan."""
    if variant not in (None, "shared", "device"):
        raise ValueError("traceback_plan: variant %r is not shared or "
                         "device" % (variant,))
    NW = TB_WARPS if warps is None else int(warps)
    if not 1 <= NW <= TB_MAX_WARPS:
        raise ValueError("traceback_plan: %r warps (1 to %d)"
                         % (warps, TB_MAX_WARPS))
    n_lists = tuple(int(x) for x in n_lists)
    it = torch.empty((), dtype=dtype).element_size()
    lists = tb_smem_bytes(Lp, dtype, n_lists, False, True) <= SMEM_LIMIT
    fits = tb_smem_bytes(Lp, dtype, n_lists, True, lists) <= SMEM_LIMIT
    if variant == "shared" and not fits:
        raise ValueError(
            "cyk_traceback: a stack of %d cells does not fit %d bytes of "
            "shared memory beside %d bytes of lists and dot counts"
            % (tb_cap(Lp), SMEM_LIMIT, tb_smem_bytes(Lp, dtype, n_lists,
                                                     False, lists)))
    if tb_smem_bytes(Lp, dtype, n_lists, False, lists) > SMEM_LIMIT:
        raise ValueError("cyk_traceback: %d bases' dot counts do not fit "
                         "shared memory" % Lp)
    stack = "shared" if fits and variant != "device" else "device"
    return TracebackPlan(Lp, it, n_lists, NW, tb_cap(Lp), stack,
                         "shared" if lists else "device",
                         tb_smem_bytes(Lp, dtype, n_lists, stack == "shared",
                                       lists))


def cyk_traceback(state, d, c, mst, eps: float, plan=None, trace=None):
    """K13 on the CYK tables ``state`` of K10-K12 (one block per read, on
    traceback_plan's layout, or ``plan`` forced): (psihat [B, Lp] int32
    node ids, pair cells [B, Lp+1, Wp+1] uint8, err [B] int32: 0 ok, 1
    step guard or stack exhausted, 2 no candidate within ``eps``).  The
    tables must be complete (every column run).  ``trace``, an int64
    [B, len(TB_TRACE)] tensor, gets the walk's counters per read."""
    st = mst.st
    _check_max_column(state, st.dims.Lp, d, c, mst)
    dev = state["O"].device
    Lp, W1 = st.dims.Lp, st.dims.Wp + 1
    B = state["O"].shape[-1]
    li, iv, tv = tb_lists(mst)
    n_lists = (li.ni, li.nt)
    if plan is None:
        plan = traceback_plan(Lp, st.dtype, n_lists)
    elif (plan.Lp, plan.itemsize, plan.n_lists) != (
            Lp, tv.element_size(), n_lists):
        raise ValueError("cyk_traceback: plan %s is not this launch's (Lp="
                         "%d, %d-byte values, lists %s)"
                         % (plan.name, Lp, tv.element_size(), n_lists))
    if not tb_rows_fit(Lp, st.dims.Wp, st.PAD, st.dims.S, d.pv.shape[2]):
        raise ValueError("cyk_traceback: the tables' rows outgrow the "
                         "kernel's 32-bit indices (Lp=%d, Wp=%d, S=%d)"
                         % (Lp, st.dims.Wp, st.dims.S))
    psihat = torch.zeros((B, Lp), dtype=torch.int32, device=dev)
    pairs = torch.zeros((B, Lp + 1, W1), dtype=torch.uint8, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    stack = torch.empty((B, plan.cap, 4), dtype=torch.int32, device=dev) \
        if plan.stack == "device" else None
    tens = {k: state[k] for k in ("LL", "P", "E", "M", "Bt", "T1", "T2",
                                  "O")}
    tens.update(eR=d.eR, eL=d.eL, bg2=d.bg2, pv=d.pv, wsp=c.wsp,
                gate_O2=c.gate_O2, gate_M=c.gate_M, hp=c.hp, stk=c.stk,
                ext=c.ext, ml2=c.ml2, mlE=c.mlE, misA=c.ep["misA"],
                misB=c.ep["misB"], SZ=mst.SZg, spec_il=c.ep["spec_il"],
                lam=state["_lam"], C=c.C, L=c.L, dcum=c.dots_cum)
    _req(c.L, "L", torch.int64, (B,), dev)
    _req(c.dots_cum, "dots_cum", torch.int32, (Lp + 1, B), dev)
    if trace is not None:
        _req(trace, "trace", torch.int64, (B, len(TB_TRACE)), dev)
    data = TbData(*[tens[f].data_ptr() for f in TB_DATA])
    _call("cyk_traceback", "cyk_traceback", state["O"],
          _dims(st, state, Lp, d), li, _aux(st, c.pin), data,
          TbCfg(float(eps), plan.cap), TbGrid(*plan.grid_args), _p(psihat),
          _p(pairs), _p(err), ctypes.c_void_p(
              None if stack is None else stack.data_ptr()),
          ctypes.c_void_p(None if trace is None else trace.data_ptr()),
          variant=plan.name)
    return psihat, pairs, err


# --------------------------------- K14-K17 rows C and D: the factors and
# the hoisted exponentials (csrc/factors.cu, csrc/hoisted.cu)

FAC_MODES = {"dp": 0, "eR": 1, "null": 2}


def factor_lists(st, ns: int):
    """K14's and K15's grammar lists on st's device, built once per
    DPStatic: the single table of each state's right and left node (a
    negative index wrapped into 0..ns-1, as torch indexing takes it) and
    the states' positional-weight flags, int32 [S] each."""
    cache = st.__dict__.setdefault("_factor_lists", {})
    if ns not in cache:
        g = st.g
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32),
                                        device=st.device)
        cache[ns] = dict(
            slot_r=i32(np.mod(g.single_table_index[g.tid_r], ns)),
            slot_l=i32(np.mod(g.single_table_index[g.tid_l], ns)),
            ws_r=i32(g.ws_r), ws_l=i32(g.ws_l))
    return cache[ns]


def slot_states(st, ns: int):
    """K15's finish lists on st's device, built once per DPStatic: for
    each slot u the states whose right (left) node takes it, in ascending
    state order, as offsets rs_off [ns+1] into rs_s [S] (ls_off, ls_s for
    the left nodes), int32."""
    cache = st.__dict__.setdefault("_slot_states", {})
    if ns not in cache:
        lists = factor_lists(st, ns)
        out = {}
        for key, slot in (("rs", "slot_r"), ("ls", "slot_l")):
            sl = lists[slot].cpu().numpy()
            order = np.argsort(sl, kind="stable").astype(np.int32)
            off = np.concatenate([[0], np.cumsum(np.bincount(
                sl, minlength=ns))]).astype(np.int32)
            out[key + "_off"] = torch.as_tensor(off, device=st.device)
            out[key + "_s"] = torch.as_tensor(order, device=st.device)
        cache[ns] = out
    return cache[ns]


def _fac_idx(st, ns):
    lists = dict(factor_lists(st, ns), **slot_states(st, ns))
    return FacIdx(*[lists[f].data_ptr() for f in FAC_IDX])


# K15's and K17's launch plans (csrc/common.cuh tree_walk, block_tree): a
# read's long sums cut into K blocks, each a residue class of K, halved
# by the last block of the read's group to finish; the sums keep
# read_sum's order whatever K, so a plan is chosen for the grid alone.
# The plan owns the layout: the launchers take its row of reads, grid and
# shared memory, and refuse a layout that is not their kernel's.
ADJ_THREADS = 256        # a block's threads (FacAdjShape, HoistAdjShape)
ADJ_ROW_BYTES = {"factors_adj": 32,     # a warp's row of reads: a sector
                 "hoisted_adj": 128}    # a line
ADJ_WARPS = ADJ_THREADS // 32
ADJ_MAX_SPLIT = 128      # blocks a read's sum may be cut into
ADJ_TARGET_BLOCKS = 512  # K17's grid: about 4 resident blocks per SM
PAIR_COLUMN_VALUES = 32  # values a column of K15's pair blocks walks
TREE_CHUNK = 8           # kTreeChunk
MAX_GRID_Y = 65535


def _pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


class AdjPlan(NamedTuple):
    """How K15 ("factors_adj") or K17 ("hoisted_adj") runs a shape:
    blocks of ``RL`` reads x ADJ_THREADS / RL columns, a grid of
    ``groups`` x ``grid_y`` blocks, a read's long sums cut into ``K``
    blocks (K17: its three trees; K15: each pair table; any power of two
    up to ``k_max`` gives the same bits), ``smem`` bytes of dynamic
    shared memory and a workspace of ``ws_elems`` values."""
    kernel: str
    RL: int
    groups: int
    grid_y: int
    K: int
    k_max: int
    smem: int
    ws_elems: int

    @property
    def name(self):
        return "K=%d" % self.K

    def splits(self):
        """Every split the plan can take: 1, 2, 4, ..., k_max."""
        return [1 << i for i in range(self.k_max.bit_length())]


def _adj_split(kernel, K, k_max, natural):
    if K is None:
        return natural
    if K < 1 or K & (K - 1) or K > k_max:
        raise ValueError("%s: a split K=%r is not a power of two up to %d"
                         % (kernel, K, k_max))
    return K


HOIST_THREADS = 256      # kHoistThreads
HOIST_VEC_BYTES = 16     # a thread's access along the reads at most
HOIST_MAX_GROUPS = 65535  # the grid's y: groups of reads


class HoistPlan(NamedTuple):
    """How K16 runs a shape: ``V`` reads a thread (16 bytes; 1 where B is
    not a multiple of it or a pointer is not 16-byte aligned), blocks of
    ``TY`` rows x ``TX`` threads along the reads, the grid's x the row
    blocks of its three ranges ``blocks`` (eSZ/eSZg: C1 x ``nub`` blocks,
    a dl and a block of u1 each; emisA; emisB by (row, w) with its four
    groups), its y ``groups`` of TX x V reads."""
    V: int
    TX: int
    TY: int
    nub: int
    blocks: tuple
    groups: int

    @property
    def name(self):
        return "V=%d" % self.V

    @property
    def grid(self):
        return (sum(self.blocks), self.groups)

    @property
    def grid_args(self):
        return (self.V, self.TX, self.TY, self.nub) + tuple(self.blocks) + (
            self.groups,)


@functools.lru_cache(maxsize=None)
def hoisted_plan(Lp, Wp, Cp, B, dtype, aligned=True):
    """K16's plan for lambda [2, B] at (Lp, Wp, Cp), emisB with the DP's
    PAD = Wp + 1 zero rows in front; ``aligned`` says that every input
    and output starts on a 16-byte boundary.  ValueError where a block's
    32-bit offsets or the grid would overflow."""
    it = torch.empty((), dtype=dtype).element_size()
    vw = HOIST_VEC_BYTES // it
    V = vw if aligned and B % vw == 0 else 1
    TX = min(32, _pow2(-(-B // V)))
    TY = HOIST_THREADS // TX
    C1, W1, Lp1, PAD = Cp + 1, Wp + 1, Lp + 1, Wp + 1
    nub = -(-C1 // TY)
    blocks = (C1 * nub, -(-4 * Lp1 * W1 // TY), -(-(Lp1 + PAD) * W1 // TY))
    groups = -(-(B // V) // TX)
    if 4 * TY * B >= 2 ** 31 or C1 * C1 * B >= 2 ** 31 \
            or sum(blocks) >= 2 ** 31 or groups > HOIST_MAX_GROUPS:
        raise ValueError("hoisted: B=%d at Lp=%d, Wp=%d, Cp=%d outgrows the "
                         "kernel's 32-bit offsets or grid" % (B, Lp, Wp, Cp))
    return HoistPlan(V, TX, TY, nub, blocks, groups)


@functools.lru_cache(maxsize=None)
def hoisted_adj_plan(Lp, Wp, Cp, n_cls, B, dtype, K=None):
    """K17's plan: one block per (group of RL reads, a warp's row of 128
    bytes, slice k of K), both buckets in a block; K the least power of
    two that gives the grid ADJ_TARGET_BLOCKS blocks, at most k_max (a
    column's values in the misA/misB trees at least a chunk, and
    ADJ_MAX_SPLIT); ``K`` forces a split.  Workspace: the partials [3
    trees][2 buckets][K][B]."""
    it = torch.empty((), dtype=dtype).element_size()
    RL = ADJ_ROW_BYTES["hoisted_adj"] // it
    C = ADJ_THREADS // RL
    groups = -(-B // RL)
    n_m = 4 * (Lp + 1) * (Wp + 1)
    if max(n_m, n_cls * (Cp + 1) ** 2) >= 2 ** 31:
        raise ValueError("hoisted_adj: the sums' 32-bit indices overflow")
    k_max = max(1, min(ADJ_MAX_SPLIT, _pow2(n_m) // (C * TREE_CHUNK)))
    nat = 1
    while nat < k_max and groups * nat < ADJ_TARGET_BLOCKS:
        nat *= 2
    K = _adj_split("hoisted_adj", K, k_max, nat)
    return AdjPlan("hoisted_adj", RL, groups, K, K, k_max, 0, 6 * K * B)


@functools.lru_cache(maxsize=None)
def factors_adj_plan(S, Lp, Wp, Tp, B, dtype, K=None):
    """K15's plan: blocks per group of RL reads, ceil((S+1) / ADJ_WARPS)
    of them a warp per state (and one for bg2), then K per pair table
    (``Tp`` tables; 0: eR alone), K such that a pair block's column walks
    PAIR_COLUMN_VALUES values (1 to ADJ_MAX_SPLIT); ``K`` forces a split.
    Shared memory: the block tree's values and the RL reads' codes.
    Workspace: the states' sums [S+1][8][B] and the pair slices' [Tp][K]
    [6][B].  ValueError where the grid or the codes do not fit."""
    it = torch.empty((), dtype=dtype).element_size()
    RL = ADJ_ROW_BYTES["factors_adj"] // it
    C = ADJ_THREADS // RL
    p_pair = _pow2((Lp + 1) * (Wp + 1))
    k_max = max(1, min(ADJ_MAX_SPLIT, p_pair))
    nat = max(1, min(ADJ_MAX_SPLIT, p_pair // (C * PAIR_COLUMN_VALUES)))
    K = _adj_split("factors_adj", K, k_max, nat)
    n_sc = -(-(S + 1) // ADJ_WARPS)
    grid_y = n_sc + Tp * K
    smem = 6 * ADJ_THREADS * it + 4 * RL * Lp
    if grid_y > MAX_GRID_Y or smem > SMEM_LIMIT:
        raise ValueError(
            "factors_adj: no grid for S=%d, Lp=%d, %d pair tables at %s "
            "(%d blocks a group of reads, at most %d; %d bytes of shared "
            "memory, at most %d)" % (S, Lp, Tp, str(dtype).replace(
                "torch.", ""), grid_y, MAX_GRID_Y, smem, SMEM_LIMIT))
    return AdjPlan("factors_adj", RL, -(-B // RL), grid_y, K, k_max, smem,
                   ((S + 1) * 8 + Tp * K * 6) * B)


def _done(st, kernel, dev, n):
    """K15's or K17's per-group counts of finished blocks on device
    ``dev`` (int32, zero between launches: the last block of a group
    resets its count), kept on the DPStatic ``st`` across calls; the
    launches of one kernel for one grammar share them, in stream
    order."""
    cache = st.__dict__.setdefault("_done_counts", {})
    key = (kernel, dev.index)
    t = cache.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 2 * (0 if t is None else t.numel())),
                        dtype=torch.int32, device=dev)
        cache[key] = t
    return t


def _weights(x, name, dt, shape, dev):
    """Per-read weights [B, n, k] as K14/K15 read them: the rows of a read
    contiguous, reads a batch stride apart (0 for the expanded copies of
    shared weights); anything else is copied contiguous."""
    if not torch.is_tensor(x) or x.device != dev or x.dtype != dt:
        raise TypeError("%s: expected %s weights on %s" % (name, dt, dev))
    if tuple(x.shape) != tuple(shape):
        raise ValueError("%s: expected shape %s, got %s"
                         % (name, tuple(shape), tuple(x.shape)))
    if not x[0].is_contiguous():
        x = x.contiguous()
    return x


def _seq_args(seq, ws, L, dots):
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError("factors kernel: the reads must be CUDA tensors")
    B, Lp = seq.shape
    _req(seq, "seq", torch.int32, (B, Lp), dev)
    _req(ws, "ws", torch.float64, (B, Lp), dev)
    _req(L, "L", torch.int32, (B,), dev)
    _req(dots, "dots", torch.bool, (B, Lp), dev)
    return dev, B, Lp


def _fac_dims(st, cfg, mode, B, Lp, S, Tp, ns, sbs, sbp):
    return FacDims(Lp, st.dims.Wp, S, B, Tp, ns, FAC_MODES[mode],
                   int(cfg.theta_softmax), int(cfg.no_theta),
                   int(cfg.no_prf), int(cfg.fix_rss), cfg.turn,
                   cfg.max_span, cfg.max_iloop, sbs, sbp)


FAC_THREADS = 256        # kFacThreads
FAC_ROW_BYTES = 128      # a group's reads in a float plane: a line
FAC_VEC_BYTES = 16       # a thread's access along the reads at most
FAC_TILES = (32, 16, 8, 4)   # positions a tile, the largest first
FAC_TARGET_BLOCKS = 264  # K14's grid: two blocks per SM of the H100


def factors_smem_bytes(Wp, Tp, ns, G, P, dtype):
    """K14's dynamic shared bytes (csrc/factors.cu factors_smem): the
    single rows [4 ns][G] and pair rows [6 Tp][G], the positional weights
    [P][G] (the DP's type), the codes [P + Wp + 1][G] and the scan's tile
    [32][G] (int32), the dots [P][G] (bytes)."""
    it = torch.empty((), dtype=dtype).element_size()
    return it * G * (4 * ns + 6 * Tp + P) + 4 * G * (P + Wp + 1) \
        + 4 * 32 * G + G * P


class FactorsPlan(NamedTuple):
    """How K14 runs a shape: groups of ``G`` reads (the grid's y,
    ``groups`` of them), blocks of ``TY`` rows x ``TX`` threads, ``V``
    reads a thread (16 bytes; 1 where B is not a multiple of it or an
    output is not 16-byte aligned); tiles of ``P`` positions, the grid's x
    ``tiles`` = (n1 (position, state) tiles, n2 (j, w) tiles, n3 position
    tiles, n4 = 1 block of the running dot counts; mode "eR" launches the
    first alone), ``smem`` bytes of dynamic shared memory."""
    V: int
    TX: int
    TY: int
    G: int
    P: int
    tiles: tuple
    groups: int
    smem: int

    @property
    def name(self):
        return "V=%d,G=%d,P=%d" % (self.V, self.G, self.P)

    @property
    def grid_args(self):
        return (self.V, self.TX, self.TY, self.G, self.P) + tuple(
            self.tiles) + (self.groups, self.smem)


@functools.lru_cache(maxsize=None)
def factors_plan(Lp, Wp, S, Tp, ns, B, dtype, aligned=True, P=None):
    """K14's plan for B reads of Lp bases at (Wp, S states, Tp pair
    tables, ns single tables); ``aligned`` says that every output written
    16 bytes at a time starts on a 16-byte boundary.  G = a line's worth
    of reads (the least power of two >= B below that), halved where the
    shared bytes would pass SMEM_LIMIT; P the largest of FAC_TILES that
    gives the grid FAC_TARGET_BLOCKS blocks (else the smallest; ``P``
    forces one).  ValueError where a block's 32-bit offsets or the grid
    would overflow, or nothing fits."""
    it = torch.empty((), dtype=dtype).element_size()
    vw = FAC_VEC_BYTES // it
    V = vw if aligned and B % vw == 0 else 1
    G = min(FAC_ROW_BYTES // it, _pow2(B))
    tiles = FAC_TILES if P is None else (P,)
    if P is not None and P not in FAC_TILES:
        raise ValueError("factors: a tile of %r positions is not one of %s"
                         % (P, FAC_TILES))
    while G >= V and factors_smem_bytes(Wp, Tp, ns, G, max(tiles),
                                        dtype) > SMEM_LIMIT:
        G //= 2
    groups = -(-B // G)
    if G < V or groups > MAX_GRID_Y:
        raise ValueError("factors: no block fits B=%d, Lp=%d, Wp=%d, ns=%d, "
                         "Tp=%d" % (B, Lp, Wp, ns, Tp))
    cdiv = lambda a, b: -(-a // b)
    for P_ in tiles:
        nt = (cdiv(Lp, P_), cdiv(Lp + 1, P_), cdiv(Lp, P_), 1)
        if sum(nt) * groups >= FAC_TARGET_BLOCKS:
            break
    if P_ * max(S, (Wp + 1) * Tp) * B >= 2 ** 31:
        raise ValueError("factors: B=%d at Lp=%d, Wp=%d, S=%d outgrows the "
                         "kernel's 32-bit offsets" % (B, Lp, Wp, S))
    return FactorsPlan(V, G // V, FAC_THREADS // (G // V), G, P_, nt, groups,
                       factors_smem_bytes(Wp, Tp, ns, G, P_, dtype))


def factors(st, cfg, mode, seq, ws, L, dots, singles=None, pairs=None,
            plan=None):
    """K14 on the grammar's DPStatic ``st`` for the ModelConfig ``cfg``,
    on factors_plan's layout (``plan`` forces one of the shape's):
    the factors of the reads (seq int32 [B, Lp], ws float64, L int32,
    dots bool) from per-read weights singles [B, ns, 4] and pairs [B, Tp,
    6] of the DP's type, as model/joint._diff_factors and _const_factors
    build them (without K1's tables).  ``mode`` "dp": every output; "eR":
    eR alone (the no-rss chain); "null": the masks pass's factors (S = 1,
    Tp = 1, zero emissions and wsp, lam 1; no weights).  A dict of
    torch tensors (FAC_OUT)."""
    dev, B, Lp = _seq_args(seq, ws, L, dots)
    dt, W1 = st.dtype, st.dims.Wp + 1
    if mode == "null":
        S, Tp, ns = 1, 1, 1
        sbs = sbp = 0
    else:
        S, ns = st.dims.S, singles.shape[1]
        singles = _weights(singles, "singles", dt, (B, ns, 4), dev)
        sbs = singles.stride(0)
        Tp, sbp = 1, 0
        if mode == "dp":
            Tp = pairs.shape[1]
            pairs = _weights(pairs, "pairs", dt, (B, Tp, 6), dev)
            sbp = pairs.stride(0)
    e = lambda shape, t=dt: torch.empty(shape, dtype=t, device=dev)
    out = {"eR": e((Lp, S, B))}
    if mode != "eR":
        i64, i32 = torch.int64, torch.int32
        out.update(eL=e((Lp, S, B)), bg2=e((Lp, B)),
                   pv=e((Lp + 1, W1, Tp, B)), alphaP=e((Lp + 1, W1, B)),
                   seq64=e((B, Lp), i64), seqT=e((Lp, B), i64),
                   L64=e((B,), i64), dcum=e((B, Lp + 1), i32),
                   dcumT=e((Lp + 1, B), i32), gate=e((Lp, B)),
                   C=e((B,), i32), wsp=e((Lp, B)))
        if mode == "null":
            out["lam"] = e((2, B))
    ptr = lambda t: None if t is None else t.data_ptr()
    aligned = all(out[k].data_ptr() % FAC_VEC_BYTES == 0 for k in (
        "eR", "eL", "bg2", "pv", "alphaP", "seqT", "gate", "wsp") if k in out)
    if plan is None:
        plan = factors_plan(Lp, st.dims.Wp, S, Tp, ns, B, dt, aligned)
    elif plan.V > 1 and not aligned:
        raise ValueError("factors: plan %s writes 16 bytes at a time, the "
                         "outputs are not aligned" % plan.name)
    _call("factors", "factors", out["eR"],
          _fac_dims(st, cfg, mode, B, Lp, S, Tp, ns, sbs, sbp),
          _fac_idx(st, ns),
          FacOut(*[ptr(out.get(f)) for f in FAC_OUT]),
          FacGrid(*plan.grid_args),
          ctypes.c_void_p(ptr(singles)), ctypes.c_void_p(ptr(pairs)),
          _p(seq), _p(ws), _p(L), _p(dots), variant=plan.name)
    return out


def factors_adj(st, cfg, mode, seq, singles, pairs, geR, geL=None,
                gbg2=None, gpv=None, split=None):
    """K15: each read's cotangent of singles [B, ns, 4] (and, in mode
    "dp", of pairs [B, Tp, 6]) from the cotangents of K14's eR, eL, bg2
    and pv (None: zero), on factors_adj_plan's layout (``split`` forces
    its K).  Returns (g_singles, g_pairs or None)."""
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError("factors_adj kernel: the reads must be CUDA tensors")
    dt = st.dtype
    B, Lp = seq.shape
    _req(seq, "seq", torch.int32, (B, Lp), dev)
    S, W1, ns = st.dims.S, st.dims.Wp + 1, singles.shape[1]
    singles = _weights(singles, "singles", dt, (B, ns, 4), dev)
    Tp, sbp = 1, 0
    if mode == "dp":
        Tp = pairs.shape[1]
        pairs = _weights(pairs, "pairs", dt, (B, Tp, 6), dev)
        sbp = pairs.stride(0)
    pair_blocks = Tp if mode == "dp" else 0
    plan = factors_adj_plan(S, Lp, st.dims.Wp, pair_blocks, B, dt, split)
    cots = {}
    for name, t, shape in (("geR", geR, (Lp, S, B)), ("geL", geL, (Lp, S, B)),
                           ("gbg2", gbg2, (Lp, B)),
                           ("gpv", gpv, (Lp + 1, W1, Tp, B))):
        if t is not None and (mode == "dp" or name == "geR"):
            t = t.contiguous()
            _req(t, name, dt, shape, dev)
            cots[name] = t
    gs = torch.empty((B, ns, 4), dtype=dt, device=dev)
    gp = torch.empty((B, Tp, 6), dtype=dt, device=dev) if mode == "dp" \
        else None
    ws = torch.empty((plan.ws_elems,), dtype=dt, device=dev)
    done = _done(st, "factors_adj", dev, plan.groups)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = FacAdjArgs(*[ptr(cots.get(f)) for f in FAC_ADJ[:4]],
                      gs.data_ptr(), ptr(gp), ws.data_ptr(), done.data_ptr())
    _call("factors_adj", "factors_adj", gs,
          _fac_dims(st, cfg, mode, B, Lp, S, Tp, ns, singles.stride(0), sbp),
          _fac_idx(st, ns), args, _p(singles), ctypes.c_void_p(ptr(pairs)),
          _p(seq), pair_blocks, plan.K, plan.RL, plan.groups, plan.grid_y,
          plan.smem, variant=plan.name)
    return gs, gp


def hoist_static(st):
    """K16's and K17's size classes on st's device, built once per
    DPStatic: the log size weights SZT [n_cls, Cp+1 (dl), Cp+1 (u1)]
    (ops/dp.hoisted's transpose of st.SZ) and their groups int32."""
    got = st.__dict__.get("_hoist_static")
    if got is None:
        SZT = torch.as_tensor(np.ascontiguousarray(
            np.transpose(st.SZ, (0, 2, 1))), dtype=st.dtype,
            device=st.device)
        grp = torch.as_tensor(np.asarray(st.grp, np.int32), device=st.device)
        got = st._hoist_static = (SZT, grp)
    return got


def _hoist_args(st, lam, c):
    dev, dt = c.C.device, st.dtype
    if dev.type != "cuda":
        raise ValueError("hoisted kernels: the factors must be CUDA tensors")
    B = c.C.shape[0]
    Lp, W1 = st.dims.Lp, st.dims.Wp + 1
    if not torch.is_tensor(lam) or lam.device != dev or lam.dtype != dt \
            or tuple(lam.shape) != (2, B):
        raise ValueError("lam: expected %s [2, %d] on %s" % (dt, B, dev))
    _req(c.C, "C", torch.int32, (B,), dev)
    for name in ("misA", "misB"):
        _req(c.ep[name], name, dt, (4, Lp + 1, W1, B), dev)
    SZT, grp = hoist_static(st)
    D = HoistDims(Lp, st.dims.Wp, st.dims.Cp, B, st.PAD, st.n_cls,
                  lam.stride(0), lam.stride(1))
    return D, HoistIn(lam.data_ptr(), SZT.data_ptr(), grp.data_ptr(),
                      c.ep["misA"].data_ptr(), c.ep["misB"].data_ptr(),
                      c.C.data_ptr())


def hoisted(st, lam, c):
    """K16: (eSZ, eSZg, emisA, emisB) of ops/dp.hoisted for lambda [2, B]
    (any strides) and the constants ``c``, on hoisted_plan's layout (16
    bytes a thread where B and every row's address allow it)."""
    D, ins = _hoist_args(st, lam, c)
    dt, dev, B = st.dtype, c.C.device, D.B
    C1, W1, Lp1 = st.dims.Cp + 1, st.dims.Wp + 1, st.dims.Lp + 1
    e = lambda *shape: torch.empty(shape, dtype=dt, device=dev)
    out = (e(2, st.n_cls, C1, C1, B), e(2, 4, C1, C1, B),
           e(2, 4, Lp1, W1, B), e(2, Lp1 + st.PAD, W1, 4, B))
    aligned = all(p % HOIST_VEC_BYTES == 0 for p in (
        ins.misA, ins.misB, *[t.data_ptr() for t in out]))
    plan = hoisted_plan(st.dims.Lp, st.dims.Wp, st.dims.Cp, B, dt, aligned)
    _call("hoisted", "hoisted", out[0], D, ins,
          HoistOut(*[t.data_ptr() for t in out]), HoistGrid(*plan.grid_args),
          variant=plan.name)
    return out


def hoisted_adj(st, lam, c, cots, split=None):
    """K17: lambda's cotangent [2, B] from the cotangents ``cots`` of
    (eSZ, eSZg, emisA, emisB) (None: zero), on hoisted_adj_plan's layout
    (``split`` forces its K)."""
    D, ins = _hoist_args(st, lam, c)
    dt, dev, B = st.dtype, c.C.device, D.B
    C1, W1, Lp1 = st.dims.Cp + 1, st.dims.Wp + 1, st.dims.Lp + 1
    plan = hoisted_adj_plan(st.dims.Lp, st.dims.Wp, st.dims.Cp, st.n_cls,
                            B, dt, split)
    shapes = ((2, st.n_cls, C1, C1, B), (2, 4, C1, C1, B),
              (2, 4, Lp1, W1, B), (2, Lp1 + st.PAD, W1, 4, B))
    ptrs = []
    for name, t, shape in zip(HOIST_OUT, cots, shapes):
        if t is not None:
            t = t.contiguous()
            _req(t, "cotangent " + name, dt, shape, dev)
        ptrs.append(t)
    glam = torch.empty((2, B), dtype=dt, device=dev)
    part = torch.empty((plan.ws_elems,), dtype=dt, device=dev)
    done = _done(st, "hoisted_adj", dev, plan.groups)
    _call("hoisted_adj", "hoisted_adj", glam, D, ins,
          HoistOut(*[None if t is None else t.data_ptr() for t in ptrs]),
          _p(glam), _p(part), _p(done), plan.K, plan.RL, plan.groups,
          variant=plan.name)
    return glam


# ------------------------------- K18-K21: the passes' ends and the glue
#
# K19 (ends_fwd/ends_adj) gathers a pass's parts and forms what its caller
# takes of them (ops/dp.Ends), and seeds the outside pass; K20 (lam_sum)
# sums lambda's per-cell partials per read; K18 (bpp_candidates/bpp_keep)
# makes the masks' candidate pairs and threshold; K21 (posteriors) the
# scanner's posteriors from its class sums.  One thread per read (K19,
# K21), per cell (K18) or the residue classes of a read's cells (K20):
# each is one launch over at most B x (Lp+1) x (Wp+1) values.

ENDS_MODES = {"parts": 0, "objective": 1, "lse": 2, "null": 3}


def _ends_struct(st, ends, B, dev):
    """EndsArgs for a launch on the grammar's DPStatic ``st``: the mode
    of ``ends`` (ops/dp.Ends) and its per-read inputs, checked."""
    if dev.type != "cuda" or st.dtype not in _SUF:
        raise ValueError("parts kernel takes float32/float64 CUDA tensors")
    if ends.mode not in ENDS_MODES:
        raise ValueError("ends: unknown mode %r" % (ends.mode,))
    a = EndsArgs(B, st.dims.S, st.PAD, ENDS_MODES[ends.mode],
                 int(bool(ends.lik_ratio)))
    a.end_states = st.k["end_states"].data_ptr()
    if ends.mode == "objective":
        for name, t in (("restrict_ari", ends.restrict_ari),
                        ("is_neg", ends.is_neg), ("valid", ends.valid)):
            _req(t, name, torch.bool, (B,), dev)
            setattr(a, name, t.data_ptr())
        for name, t in (("lik_sign", ends.lik_sign), ("eff", ends.eff)):
            _req(t, name, st.dtype, (B,), dev)
            setattr(a, name, t.data_ptr())
    return a


def _ends_rows(st, O, L, B, dev):
    _req(O, "O", st.dtype, (st.dims.Lp + 1 + st.PAD, st.dims.S, B), dev)
    _req(L, "L", torch.int64, (B,), dev)
    return O.data_ptr(), L.data_ptr()


def ends_fwd(st, ends, O=None, L=None, parts=None):
    """K19's forward on the grammar's DPStatic ``st``: the parts [B, 3]
    of the inside table O [Lp+1+PAD, S, B] at rows L + PAD (L int64
    [B]), or the given parts [B, 3] (the no-rss chain's), and what
    ``ends`` (ops/dp.Ends) forms of them: (parts, y [B] or None, y2 [B]
    or None)."""
    src = parts if O is None else O
    B = src.shape[0] if O is None else src.shape[-1]
    dev, dt = src.device, st.dtype
    a = _ends_struct(st, ends, B, dev)
    if O is None:
        _req(parts, "parts", dt, (B, 3), dev)
        a.parts_in = parts.data_ptr()
    else:
        a.O, a.L = _ends_rows(st, O, L, B, dev)
        parts = torch.empty((B, 3), dtype=dt, device=dev)
        a.parts = parts.data_ptr()
    y = y2 = None
    if ends.mode != "parts":
        y = torch.empty((B,), dtype=dt, device=dev)
        a.y = y.data_ptr()
    if ends.mode in ("objective", "lse"):
        y2 = torch.empty((B,), dtype=dt, device=dev)
        a.y2 = y2.data_ptr()
    _call("parts", "ends_fwd", src, a)
    return parts, y, y2


def ends_adj(st, ends, parts, gy=None, gparts=None, gO=None, L=None,
             gbar=False):
    """K19's adjoint: the parts' cotangent [B, 3] from that of the mode's
    output gy [B] and a cotangent of the parts gparts [B, 3] (either
    None), added into the outside pass's O cotangent gO [Lp+1+PAD, S, B]
    at rows L + PAD when it is given, and returned when ``gbar``."""
    B, dev, dt = parts.shape[0], parts.device, st.dtype
    a = _ends_struct(st, ends, B, dev)
    _req(parts, "parts", dt, (B, 3), dev)
    a.parts = parts.data_ptr()
    if gy is not None:
        gy = gy.contiguous()
        _req(gy, "cotangent of the parts' output", dt, (B,), dev)
        a.gy = gy.data_ptr()
    if gparts is not None:
        gparts = gparts.contiguous()
        _req(gparts, "cotangent of the parts", dt, (B, 3), dev)
        a.gparts = gparts.data_ptr()
    if gO is not None:
        a.gO, a.L = _ends_rows(st, gO, L, B, dev)
    out = torch.empty((B, 3), dtype=dt, device=dev) if gbar else None
    if out is not None:
        a.gbar = out.data_ptr()
    if gO is None and out is None:
        raise ValueError("ends_adj: neither gO nor gbar to write")
    _call("parts", "ends_adj", parts, a)
    return out


LAM_SUM_ROW_BYTES = 128  # LamSumShape: a warp's row of reads, one line


def lam_states(st):
    """K20's states in (bucket, index) order, int32 on st's device, and
    the buckets' offsets in it (built once per DPStatic)."""
    got = st.__dict__.get("_lam_states")
    if got is None:
        bu = np.asarray(st.g.lam_bucket)
        if not np.isin(bu, (0, 1)).all():
            raise ValueError("lambda buckets must be 0 or 1")
        order = np.argsort(bu, kind="stable").astype(np.int32)
        got = st._lam_states = (torch.as_tensor(order, device=st.device),
                                (0, int((bu == 0).sum()), len(bu)))
    return got


def lam_sum(st, DL, lam, extra=None):
    """K20: lambda's per-read cotangent [2, B] = (lam [2, B] + per bucket
    the sum of K5's and K7's per-cell partials DL [Lp+1, Wp+1, S, B] over
    the bucket's states) + extra [2, B] (if given), every sum in
    ops/dp.read_sum's order: ops/dp.lam_sum_plain's bits."""
    dev, dt = DL.device, st.dtype
    if dev.type != "cuda" or dt not in _SUF:
        raise ValueError("lam_sum kernel takes float32/float64 CUDA tensors")
    Lp1, W1, S, B = st.dims.Lp + 1, st.dims.Wp + 1, st.dims.S, DL.shape[-1]
    _req(DL, "DL", dt, (Lp1, W1, S, B), dev)
    _req(lam, "lam", dt, (2, B), dev)
    if extra is not None:
        extra = extra.contiguous()
        _req(extra, "extra", dt, (2, B), dev)
    states, off = lam_states(st)
    groups = -(-B // (LAM_SUM_ROW_BYTES // DL.element_size()))
    out = torch.empty((2, B), dtype=dt, device=dev)
    ws = torch.empty((S * B,), dtype=dt, device=dev)
    done = _done(st, "lam_sum", dev, groups)
    _call("lam_sum", "lam_sum", DL, LamSumArgs(
        Lp1 * W1, S, B, DL.data_ptr(), lam.data_ptr(),
        None if extra is None else extra.data_ptr(), states.data_ptr(),
        (ctypes.c_int * 3)(*off), out.data_ptr(), ws.data_ptr(),
        done.data_ptr()), groups)
    return out


def bpp_candidates(pair, seq, L, Wp: int, max_span: int, turn: int, dtype):
    """K18's candidates: bp0 [B, Lp+1, Wp+1] bool of
    energy/tables.pair_mask_jw for the codes seq int32 [B, Lp], the
    lengths L int32 [B] and the pair types ``pair`` int64 [5, 5] (the
    energy tables' "bp"); ``dtype`` picks the instantiation."""
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError("bpp kernel: the reads must be CUDA tensors")
    B, Lp = seq.shape
    _req(seq, "seq", torch.int32, (B, Lp), dev)
    _req(L, "L", torch.int32, (B,), dev)
    _req(pair, "pair types", torch.int64, (5, 5), dev)
    out = torch.empty((B, Lp + 1, Wp + 1), dtype=torch.bool, device=dev)
    _call("bpp_keep", "bpp_candidates", out, BppArgs(
        Lp, Wp, B, max_span, 1 if turn == 0 else turn + 2, seq.data_ptr(),
        L.data_ptr(), pair.data_ptr(), None, None, None, 0.0,
        out.data_ptr(), None), dtype=dtype)
    return out


def bpp_keep(bp0, sel, post, min_bpp: float, dtype):
    """K18's threshold: (keep [B, Lp+1, Wp+1] bool, eff [B] of ``dtype``)
    with keep = sel & (log(max(post, 1e-300)) >= log(min_bpp)) for the
    motif-free posterior post [Lp+1, Wp+1, B] (batch-minor; None keeps
    sel) and eff = count(keep) / max(count(bp0), 1)."""
    dev = bp0.device
    if dev.type != "cuda":
        raise ValueError("bpp kernel: the masks must be CUDA tensors")
    B, Lp1, W1 = bp0.shape
    _req(bp0, "bp0", torch.bool, (B, Lp1, W1), dev)
    _req(sel, "sel", torch.bool, (B, Lp1, W1), dev)
    if post is not None:
        _req(post, "post", dtype, (Lp1, W1, B), dev)
    keep = torch.empty_like(bp0)
    eff = torch.empty((B,), dtype=dtype, device=dev)
    _call("bpp_keep", "bpp_keep", eff, BppArgs(
        Lp1 - 1, W1 - 1, B, 0, 0, None, None, None, bp0.data_ptr(),
        sel.data_ptr(), None if post is None else post.data_ptr(),
        math.log(min_bpp) if post is not None else 0.0, keep.data_ptr(),
        eff.data_ptr()))
    return keep, eff


def posteriors(g, L, end: bool):
    """K21 from the class-probe cotangent g [4, Lp, B] and L int64 [B]:
    pass 1 (end False) (Pys [B, Lp], Pyi [B, Lp], Ys int64 [B], Ys int32
    [B], the end pass's pin); the end pass (Pye [B, Lp+1], Ye int64
    [B])."""
    dev, dt = g.device, g.dtype
    if dev.type != "cuda":
        raise ValueError("posteriors kernel takes CUDA tensors")
    _, Lp, B = g.shape
    _req(g, "class sums", dt, (4, Lp, B), dev)
    _req(L, "L", torch.int64, (B,), dev)
    e = lambda shape, t=dt: torch.empty(shape, dtype=t, device=dev)
    arg = e((B,), torch.int64)
    if end:
        P0, P1, pin = e((B, Lp + 1)), None, None
    else:
        P0, P1, pin = e((B, Lp)), e((B, Lp)), e((B,), torch.int32)
    ptr = lambda t: None if t is None else t.data_ptr()
    _call("posteriors", "posteriors", g, PostArgs(
        Lp, B, int(end), g.data_ptr(), L.data_ptr(), ptr(P0), ptr(P1),
        arg.data_ptr(), ptr(pin)))
    return (P0, arg) if end else (P0, P1, arg, pin)
