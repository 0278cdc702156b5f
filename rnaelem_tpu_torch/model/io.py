"""train.model file IO, byte-compatible with the reference
(motif_io.hpp:29-87 writer, 118-262 reader).

The text format doubles as the checkpoint/interop surface: models written
here are readable by the reference binary and vice versa.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

import torch

from .. import device as DEV
from ..grammar.profile import compile_pattern
from . import joint as J


def _g(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    s = "%g" % x
    return s


def _fmt_table(tables: List[np.ndarray]) -> str:
    return "[" + ",".join(
        "[" + ",".join(_g(float(v)) for v in t) + "]" for t in tables
    ) + "]"


def _tables_in_order(g, p: J.Params) -> List[np.ndarray]:
    singles, pairs = J._np(p.singles), J._np(p.pairs)
    out = []
    for t, sz in enumerate(g.table_sizes):
        if sz == 6:
            out.append(pairs[g.pair_table_index[t]])
        else:
            out.append(singles[g.single_table_index[t]])
    return out


def model_lines(cfg: J.ModelConfig, params: J.Params) -> List[str]:
    g = compile_pattern(cfg.pattern)
    pattern = g.reg_pattern
    if cfg.no_rss:
        pattern = pattern.replace(".", "_")
    lines = [f"pattern: {pattern}"]
    raw = _tables_in_order(g, params)
    if cfg.theta_softmax:
        lines.append("s: " + _fmt_table(raw))
        th = J.effective_theta(cfg, params)
    else:
        lines.append("theta: " + _fmt_table(raw))
        th = params
    exp_t = [np.exp(t) for t in _tables_in_order(g, th)]
    lines.append("exp-theta: " + _fmt_table(exp_t))
    lines.append(f"ene-param: {cfg.energy}")
    lines.append(f"max-span: {cfg.max_span}")
    lines.append(f"max-internal-loop: {cfg.max_iloop}")
    lines.append(f"theta-softmax: {1 if cfg.theta_softmax else 0}")
    if cfg.theta_softmax:
        lines.append(f"rho-s: {_g(cfg.rho_s)}")
    else:
        lines.append(f"rho-theta: {_g(cfg.rho_theta)}")
    lines.append(f"rho-lambda: {_g(cfg.rho_lambda)}")
    lines.append(f"tau: {_g(cfg.tau)}")
    lam = J._np(params.lam)
    lines.append("lambda: [" + ",".join(_g(float(v)) for v in lam) + "]")
    lines.append(f"lambda-prior: {_g(cfg.lambda_prior)}")
    lines.append(f"min-bpp: {_g(cfg.min_bpp)}")
    lines.append(f"no-rss: {1 if cfg.no_rss else 0}")
    lines.append(f"no-profile: {1 if cfg.no_prf else 0}")
    lines.append(f"no-energy: {1 if cfg.no_ene else 0}")
    return lines


def write_model(path_or_file, cfg: J.ModelConfig, params: J.Params):
    text = "\n".join(model_lines(cfg, params)) + "\n"
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
    else:
        with open(path_or_file, "w") as f:
            f.write(text)


def interim_line(cfg: J.ModelConfig, params: J.Params) -> str:
    """One-line snapshot (motif_io.hpp:58-87)."""
    return "interim: " + " ".join(model_lines(cfg, params))


def _parse_table(s: str) -> List[List[float]]:
    x, stack = [], []
    j0, j1 = s.find("["), s.rfind("]")
    for j in range(j0 + 1, j1):
        if s[j] == "[":
            stack.append(j)
        elif s[j] == "]":
            i = stack.pop()
            x.append([float(v) for v in s[i + 1: j].split(",") if v != ""])
    return x


def read_model(path, Lp: int, dtype="float64", device=None,
               **overrides) -> Tuple[J.ModelConfig, J.Params]:
    """Parse a train.model file into (ModelConfig, Params on ``device``).

    Mirrors RNAelemReader::read_model (motif_io.hpp:118-262) incl. the
    required-field check; extra kwargs override config fields (e.g. Lp).
    """
    dev = DEV.resolve(device)
    kv = {}
    with open(path) as f:
        for line in f:
            if ": " not in line:
                continue
            key, val = line.split(": ", 1)
            kv[key.strip()] = val.strip()

    required = ["pattern", ("s", "theta"), "ene-param", "max-span",
                ("rho-s", "rho-theta"), "rho-lambda", "tau", "lambda",
                "min-bpp", "max-internal-loop", "theta-softmax"]
    for r in required:
        if isinstance(r, tuple):
            if not any(k in kv for k in r):
                raise ValueError(f"motif file broken: missing one of {r}")
        elif r not in kv:
            raise ValueError(f"motif file broken: missing {r}")

    softmax = bool(int(kv["theta-softmax"]))
    no_rss = bool(int(kv.get("no-rss", "0")))
    pattern = kv["pattern"]
    if no_rss:
        pattern = pattern.replace("_", ".")
    cfg_kw = dict(
        pattern=pattern, Lp=Lp,
        max_span=int(kv["max-span"]),
        max_iloop=int(kv["max-internal-loop"]),
        min_bpp=float(kv["min-bpp"]),
        energy=kv["ene-param"],
        theta_softmax=softmax,
        no_rss=no_rss,
        no_prf=bool(int(kv.get("no-profile", "0"))),
        no_ene=bool(int(kv.get("no-energy", "0"))),
        tau=float(kv["tau"]),
        rho_s=float(kv.get("rho-s", "0")),
        rho_theta=float(kv.get("rho-theta", "0")),
        rho_lambda=float(kv["rho-lambda"]),
        lambda_prior=float(kv.get("lambda-prior", "0")),
        dtype=dtype,
    )
    cfg_kw.update(overrides)
    cfg = J.ModelConfig(**cfg_kw)

    g = compile_pattern(cfg.pattern)
    w = _parse_table(kv["s"] if softmax else kv["theta"])
    if len(w) != len(g.table_sizes):
        raise ValueError("table count mismatch in model file")
    dt = DEV.torch_dtype(dtype)
    ns = int((g.single_table_index >= 0).sum())
    npair = max(1, g.n_pair_tables)
    singles = np.zeros((ns, 4))
    pairs = np.zeros((npair, 6))
    for t, vals in enumerate(w):
        if g.table_sizes[t] == 6:
            pairs[g.pair_table_index[t]] = vals
        else:
            singles[g.single_table_index[t]] = vals
    lam_s = kv["lambda"]
    lam = [float(v) for v in
           lam_s[lam_s.find("[") + 1: lam_s.rfind("]")].split(",")]
    params = J.Params(
        singles=torch.as_tensor(singles, dtype=dt, device=dev),
        pairs=torch.as_tensor(pairs, dtype=dt, device=dev),
        lam=torch.as_tensor(lam, dtype=dt, device=dev))
    return cfg, params
