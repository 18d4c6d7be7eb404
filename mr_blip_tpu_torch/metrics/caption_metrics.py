"""Caption metrics: corpus BLEU-4 and CIDEr-D (pure python; the port's copy
of ``mr_blip_tpu/metrics/caption_metrics.py``), and the retrieval recalls.

Counterpart of the reference's pycocoevalcap dependency (used by the LAVIS
captioning task): corpus-level BLEU with brevity penalty, and CIDEr-D —
tf-idf weighted n-gram cosine similarity (n = 1..4) with length penalty.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _tokenize(s: str) -> List[str]:
    return s.lower().strip().split()


def corpus_bleu(predictions: List[str], references: List[List[str]],
                max_n: int = 4) -> float:
    """Corpus BLEU-max_n with clipped precision and brevity penalty."""
    match = [0] * max_n
    total = [0] * max_n
    pred_len = 0
    ref_len = 0
    for pred, refs in zip(predictions, references):
        p = _tokenize(pred)
        rs = [_tokenize(r) for r in refs]
        pred_len += len(p)
        ref_len += min((abs(len(r) - len(p)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            p_ng = _ngrams(p, n)
            max_ref = Counter()
            for r in rs:
                r_ng = _ngrams(r, n)
                for g, c in r_ng.items():
                    max_ref[g] = max(max_ref[g], c)
            total[n - 1] += max(len(p) - n + 1, 0)
            match[n - 1] += sum(min(c, max_ref[g]) for g, c in p_ng.items())
    if min(match) == 0:
        return 0.0
    log_prec = sum(math.log(m / t) for m, t in zip(match, total)) / max_n
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
    return 100.0 * bp * math.exp(log_prec)


def cider_d(predictions: List[str], references: List[List[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D over the evaluation corpus (df computed from references)."""
    num_docs = len(references)
    doc_freq: Dict[tuple, int] = {}
    tokenized_refs = []
    for refs in references:
        rs = [_tokenize(r) for r in refs]
        tokenized_refs.append(rs)
        seen = set()
        for r in rs:
            for n in range(1, max_n + 1):
                seen.update(_ngrams(r, n).keys())
        for g in seen:
            doc_freq[g] = doc_freq.get(g, 0) + 1

    def tfidf(tokens, n):
        ng = _ngrams(tokens, n)
        vec = {}
        norm = 0.0
        for g, c in ng.items():
            idf = math.log(max(num_docs, 1)) - math.log(max(doc_freq.get(g, 0), 1))
            w = c * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for pred, rs in zip(predictions, tokenized_refs):
        p = _tokenize(pred)
        score_n = []
        for n in range(1, max_n + 1):
            pv, pn = tfidf(p, n)
            sims = []
            for r in rs:
                rv, rn = tfidf(r, n)
                dot = sum(min(pv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g in pv)
                delta = len(p) - len(r)
                penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
                sims.append(penalty * dot / max(pn * rn, 1e-9))
            score_n.append(sum(sims) / max(len(sims), 1))
        scores.append(sum(score_n) / max_n)
    return 100.0 * 10.0 * (sum(scores) / max(len(scores), 1))


def retrieval_metrics(score_matrix, i2t_gt=None,
                      score_matrix_t2i=None) -> Dict[str, float]:
    """R@1/5/10 + median rank for both directions of an (N_img, N_txt)
    similarity matrix (identity ground truth unless ``i2t_gt`` maps image
    index -> list of correct text indices). Pass ``score_matrix_t2i``
    ((N_txt, N_img)) when the two directions were reranked separately
    (ITM rerank produces asymmetric matrices — reference LAVIS
    compute_sim_matrix protocol); otherwise the transpose is used."""
    import numpy as np

    scores = np.asarray(score_matrix)
    n_img, n_txt = scores.shape
    gt = i2t_gt or {i: [i] for i in range(n_img)}

    def ranks(sim, gold):
        out = []
        for i in range(sim.shape[0]):
            order = np.argsort(-sim[i])
            best = min(int(np.where(order == g)[0][0]) for g in gold[i])
            out.append(best)
        return np.array(out)

    t2i_gt = {}
    for i, txts in gt.items():
        for t in txts:
            t2i_gt.setdefault(t, []).append(i)
    scores_t2i = (np.asarray(score_matrix_t2i)
                  if score_matrix_t2i is not None else scores.T)
    r_i2t = ranks(scores, gt)
    r_t2i = ranks(scores_t2i, t2i_gt)

    def pack(r, prefix):
        return {
            f"{prefix}_r1": float((r < 1).mean() * 100),
            f"{prefix}_r5": float((r < 5).mean() * 100),
            f"{prefix}_r10": float((r < 10).mean() * 100),
            f"{prefix}_medr": float(np.median(r) + 1),
        }

    out = pack(r_i2t, "txt")  # image -> text retrieval
    out.update(pack(r_t2i, "img"))
    out["r_mean"] = float(
        np.mean([out["txt_r1"], out["txt_r5"], out["txt_r10"],
                 out["img_r1"], out["img_r5"], out["img_r10"]])
    )
    return out
