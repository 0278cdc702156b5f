"""Scan driver (PyTorch): per-read posterior records and the motif
alignment (JAX scan/driver.py).

Produces the 10-line raw record stream of the reference scanner
(motif_scanner.hpp:237-252) and the aggregated E[N] log line
(motif_scanner.hpp:947) that draw_motif consumes.  Reads are grouped in
length buckets of 32 and scanned SCAN_BATCH at a time: the posteriors
through scan.scanner.scan_posteriors_batch, then, for a structure model,
the chunk's Viterbi alignments (psihat and rss) through scan.cyk.cyk_batch
(the CYK tables and their traceback, K10-K13 on the card) on the same
min-BPP masks; ragged last chunks are not padded (the kernels do not
specialise on the batch size).  A --no-rss model's psihat comes from the
host Viterbi chain ``_chain_viterbi`` and its rss is all 'O'.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from .. import device as DEV
from ..alphabet import ints_to_seq
from ..io.fastq import FastqReader
from ..model import joint as J
from ..model.io import _g
from ..ops import dp as DP
from . import cyk as CYK
from . import scanner as SC

SCAN_BATCH = 64


def _fmt_vec(v) -> str:
    return "[" + ",".join(_g(float(x)) for x in v) + "]"


def _fmt_ivec(v) -> str:
    return "[" + ",".join(str(int(x)) for x in v) + "]"


def _log_or_neg(x):
    x = float(x)
    return np.log(x) if x > 0 else -np.inf


def posterior_lines(Pys, Pye, Pyi, Ys, Ye):
    """The start, end, inner, motif region and exist prob lines of one
    read's record."""
    return ["start: " + _fmt_vec([_log_or_neg(v) for v in Pys]),
            "end: " + _fmt_vec([_log_or_neg(v) for v in Pye]),
            "inner: " + _fmt_vec([_log_or_neg(v) for v in Pyi]),
            f"motif region: {Ys} - {Ye}",
            f"exist prob: {_g(float(Pys.sum()))}"]


def scan_config(cfg: J.ModelConfig, params: J.Params, Lp: int):
    """The scanner works in plain-theta space (the reference scanner
    reads theta; E[N] accumulates per theta table)."""
    th = J.effective_theta(cfg, params)
    cfg2 = dataclasses.replace(cfg, theta_softmax=False, Lp=Lp)
    return cfg2, J.Params(singles=th.singles.detach(),
                          pairs=th.pairs.detach(), lam=params.lam.detach())


def _bucket_of(L: int, lo: int = 32, step: int = 32) -> int:
    """Length bucket: round up to a multiple of ``step`` (min ``lo``)."""
    return max(lo, ((L + step - 1) // step) * step)


class Scanner:
    def __init__(self, cfg: J.ModelConfig, params: J.Params, device=None):
        self.device = DEV.resolve(device)
        self.cfg0 = cfg
        self.params0 = J.Params(*[x.to(self.device) for x in params])

    def _run(self, fq_path: str, mark):
        """(reads, per read (Pys [L], Pye [L+1], Pyi [L], Ys, Ye, its
        alignment (psihat [L], rss) from the chunk's CYK pass for a
        structure model, else None) as numpy, E[N] singles and pairs
        summed over the reads, the grammar).  ``mark`` goes to
        scan_posteriors_batch and cyk_batch."""
        reads = list(FastqReader(fq_path).reads())
        buckets = {}
        for idx, r in enumerate(reads):
            buckets.setdefault(_bucket_of(len(r.seq)), []).append(idx)
        results = [None] * len(reads)
        EN_singles = EN_pairs = g0 = None
        for Lp in sorted(buckets):
            cfg, params = scan_config(self.cfg0, self.params0, Lp)
            if g0 is None:
                g0 = J.kernels(cfg, self.device).g
                EN_singles = np.zeros(tuple(params.singles.shape),
                                      J._np(params.singles).dtype)
                EN_pairs = np.zeros(tuple(params.pairs.shape),
                                    J._np(params.pairs).dtype)
            idxs = buckets[Lp]
            for k0 in range(0, len(idxs), SCAN_BATCH):
                chunk = idxs[k0:k0 + SCAN_BATCH]
                sd_b = J.stack_seqdata(
                    [J.make_seqdata(cfg, reads[i].seq, reads[i].qual)
                     for i in chunk], self.device)
                res = SC.scan_posteriors_batch(cfg, params, sd_b,
                                               device=self.device, mark=mark)
                EN_singles += J._np(res["EN"].singles)
                EN_pairs += J._np(res["EN"].pairs)
                aln = [None] * len(chunk)
                if not cfg.no_rss:
                    aln = CYK.cyk_batch(cfg, params, sd_b, res["Ys"],
                                        res["Ye"], res["bp_ok"],
                                        device=self.device, mark=mark)
                out = {k: J._np(res[k]) for k in ("Pys", "Pye", "Pyi", "Ys",
                                                   "Ye")}
                for t, i in enumerate(chunk):
                    L = len(reads[i].seq)
                    results[i] = (out["Pys"][t][:L], out["Pye"][t][:L + 1],
                                  out["Pyi"][t][:L], int(out["Ys"][t]),
                                  int(out["Ye"][t]), aln[t])
        return reads, results, (EN_singles, EN_pairs), g0

    def scan(self, fq_path: str, out, log=None, mark=None):
        """Write the 10-line record of every read to ``out`` and the E[N]
        line to ``log`` (stderr by default).  ``mark`` goes to the
        posterior and CYK passes."""
        if log is None:
            log = sys.stderr
        t0 = time.time()
        reads, results, (EN_singles, EN_pairs), g0 = self._run(fq_path,
                                                                mark)
        if not reads:
            print("E[N]: []", file=log)
            return
        M = g0.M
        for r, (Pys, Pye, Pyi, Ys, Ye, aln) in zip(reads, results):
            L = len(r.seq)
            if aln is None:
                cfg, params = scan_config(self.cfg0, self.params0,
                                          _bucket_of(L))
                psihat = _chain_viterbi(cfg, params, g0, r.seq, r.qual, Ys,
                                        Ye, L)
                rss = "O" * L
            else:
                psihat, rss = aln
            mot = "".join(" " if (p == 0 or p == M - 1) else g0.nodes[int(p)]
                          for p in psihat)
            out.write(f"id: {r.id}\n")
            lines = posterior_lines(Pys, Pye, Pyi, Ys, Ye)
            for line in lines[:3]:
                out.write(line + "\n")
            out.write("psihat: " + _fmt_ivec(psihat) + "\n")
            for line in lines[3:]:
                out.write(line + "\n")
            out.write(f"seq: {ints_to_seq(r.seq)}\n")
            out.write(f"rss: {rss}\n")
            out.write(f"mot: {mot}\n")
        en_tabs = []
        for t, sz in enumerate(g0.table_sizes):
            if sz == 6:
                en_tabs.append(EN_pairs[g0.pair_table_index[t]])
            else:
                en_tabs.append(EN_singles[g0.single_table_index[t]])
        print("E[N]:", "[" + ",".join(_fmt_vec(t) for t in en_tabs) + "]",
              file=log)
        print("scan end:", time.time() - t0, file=log)


def _chain_viterbi(cfg, params, g, seq, qual, Ys, Ye, L):
    """no-rss Viterbi on the host: max-semiring forward chain over the
    motif states with the Ys/Ye pins, traced back (compute_inside no-rss
    branch + CYKFun, motif_model.hpp:170-190 / motif_scanner.hpp:830-873;
    JAX driver._chain_viterbi)."""
    S = g.S
    sd = J.make_seqdata(cfg, seq, qual)
    base = np.asarray(sd.seq)
    b1 = np.clip(base - 1, 0, 3)
    sidx = g.single_table_index[g.tid_r]
    singles = J._np(J.effective_theta(cfg, params).singles)
    eR = np.where((base > 0)[:, None] & (not cfg.no_prf),
                  singles[sidx[None, :], b1[:, None]], 0.0)
    eR = eR + np.where(np.asarray(g.ws_r)[None, :],
                       np.asarray(sd.ws)[:, None], 0.0)
    ltau = np.log(cfg.tau) if cfg.tau > 0 else -np.inf
    TR = np.where(g.rt, np.where(g.rt_tau, ltau, 0.0), -np.inf)
    code = DP.class_codes(g)[0]
    r_start = (code & DP.CLS_START) != 0
    r_end = (code & DP.CLS_END) != 0
    r_tail = (code & DP.CLS_TAIL) != 0

    def allow(p):
        a = np.zeros((S, S))
        if p == Ys:
            a = np.where(r_start, 0.0, -np.inf)
        if p == Ye:
            a = a + np.where(r_end, 0.0, -np.inf)
        if Ye == L and p == L - 1:
            a = a + np.where(r_tail, 0.0, -np.inf)
        return a

    v = np.full(S, -np.inf)
    v[g.end_states[0]] = 0.0
    back = np.zeros((L, S), np.int64)
    for p in range(L):
        # t[s, s1]: target-state s emits base p through node s.r
        t = v[None, :] + TR + eR[p][:, None] + allow(p)
        back[p] = np.argmax(t, axis=1)
        v = t[np.arange(S), back[p]]
    ends = [g.end_states[1], g.end_states[2]]
    s = ends[1] if v[ends[0]] < v[ends[1]] else ends[0]
    path = np.zeros(L, np.int64)
    for p in range(L - 1, -1, -1):
        path[p] = g.state_r[s]
        s = back[p, s]
    return path
