"""Device-resident log-score tables memoised from model parameters.

The equivalent of the reference's QuaffScores (src/qmodel.cpp:296-325):
all transition log-probs and the full [ref symbol, read k-mer, quality]
emission tables are precomputed host-side in float64 and shipped to the
device once per parameter set, so the DP kernels only do gathers and adds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..alphabet import ALPHABET_SIZE, QUAL_SCORE_RANGE
from ..model.negbinom import log_negative_binomial_array
from ..model.params import QuaffParams


@dataclass
class ScoreTables:
    match_kmer_len: int
    indel_kmer_len: int
    # emissions
    match_score: np.ndarray  # [4, Km, Q]  log P(read sym+qual | ref sym, kmer ctx)
    match_score_noq: np.ndarray  # [4, Km]
    insert_score: np.ndarray  # [4, Q]
    insert_score_noq: np.ndarray  # [4]
    # transitions
    m2m: np.ndarray  # [Ki]
    m2i: np.ndarray  # [Ki]
    m2d: np.ndarray  # [Ki]
    m2e: np.ndarray  # [Ki]
    d2d: float
    d2m: float
    i2i: float
    i2m: float

    @classmethod
    def from_params(cls, qp: QuaffParams) -> "ScoreTables":
        # Every log below is the scalar libm math.log, and every table entry
        # is built with the reference's exact op sequence
        # (SymQualScores ctor, qmodel.cpp:87-93: logSymProb = log(symProb);
        # logSymQualProb[q] = logSymProb + log(nb_pdf(q))), so the f64
        # tables are BITWISE identical to the oracle's QuaffScores —
        # required for tie-class Viterbi traceback parity (round 4).
        import math

        q = np.arange(QUAL_SCORE_RANGE)
        km = qp.num_match_kmers
        match_noq = np.empty((ALPHABET_SIZE, km))
        match = np.empty((ALPHABET_SIZE, km, QUAL_SCORE_RANGE))
        for i in range(ALPHABET_SIZE):
            for j in range(km):
                lsym = math.log(qp.match_prob[i, j])
                match_noq[i, j] = lsym
                match[i, j] = lsym + log_negative_binomial_array(
                    q, qp.match_q[i, j], qp.match_r[i, j]
                )
        ins_noq = np.empty(ALPHABET_SIZE)
        ins = np.empty((ALPHABET_SIZE, QUAL_SCORE_RANGE))
        for i in range(ALPHABET_SIZE):
            lsym = math.log(qp.insert_prob[i])
            ins_noq[i] = lsym
            ins[i] = lsym + log_negative_binomial_array(
                q, qp.insert_q[i], qp.insert_r[i]
            )
        ki = qp.num_indel_kmers
        m2m = np.empty(ki)
        m2i = np.empty(ki)
        m2d = np.empty(ki)
        m2e = np.empty(ki)
        for j in range(ki):
            bi = float(qp.begin_insert[j])
            bd = float(qp.begin_delete[j])
            m2m[j] = math.log(1 - bi) + math.log(1 - bd)
            m2i[j] = math.log(bi)
            m2d[j] = math.log(1 - bi) + math.log(bd)
            m2e[j] = math.log(bi)
        return cls(
            match_kmer_len=qp.match_kmer_len,
            indel_kmer_len=qp.indel_kmer_len,
            match_score=match,
            match_score_noq=match_noq,
            insert_score=ins,
            insert_score_noq=ins_noq,
            m2m=m2m,
            m2i=m2i,
            m2d=m2d,
            m2e=m2e,
            d2d=math.log(float(qp.extend_delete)),
            d2m=math.log(1 - float(qp.extend_delete)),
            i2i=math.log(float(qp.extend_insert)),
            i2m=math.log(1 - float(qp.extend_insert)),
        )
