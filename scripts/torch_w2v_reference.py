#!/usr/bin/env python3
"""The port's Word2Vec against the JAX package's, on the CPU, at the
full-width configuration of ``chip_smoke.py``'s phase 6, from the same
tables.

    JAX_PLATFORMS=cpu python3 scripts/torch_w2v_reference.py \
        [--sentences N] [--perturb EPS [--perturb-port]] [--clip]
        [--out PATH]

Both sides train ``Word2Vec(layer_size=100, window=5, batch_pairs=4096,
lr=0.025, min_word_frequency=1, epochs=1)`` (HS) on the first N sentences
(default 4,000) of phase 6's synthetic corpus (1,000 tokens each, Zipf(1.0)
over 71,290 word types, seed 0), starting from the same syn0 (uniform in
[-0.5, 0.5) / D from a numpy generator, seed 0) and zero syn1. Reports, for
each fit, the seconds, max |syn0| and its row, max |syn1|, and between the
port and the reference the largest difference and the rows that differ by
more than 1e-3.

``--perturb EPS`` adds a reference fit from syn0 * (1 + EPS): how far a
last-bit difference carries at this batch size; ``--perturb-port`` adds
the same nudged fit on the port's side. ``--clip`` adds a port fit
that clips saturated dots instead of skipping them (the fault the
reference's ``test_word2vec_many_epochs_stays_bounded`` guards against).

A comparison tool like the tests: it imports JAX and the JAX package, which
the port never does. Prints one JSON line, and writes it to PATH with
``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
D = 100


def _fit(side: str, corpus: list[str], syn0: np.ndarray,
         clip: bool = False) -> tuple[dict, np.ndarray]:
    cfg = dict(layer_size=D, window=5, batch_pairs=4096, lr=0.025,
               min_word_frequency=1, epochs=1)
    syn1 = np.zeros((len(syn0) - 1, D), np.float32)
    syn1neg = np.zeros_like(syn0)
    if side == "reference":
        import jax.numpy as jnp

        from deeplearning4j_tpu.models.word2vec import Word2Vec
        from deeplearning4j_tpu.nlp.sentence_iterator import (
            CollectionSentenceIterator,
        )

        m = Word2Vec(**cfg)
        m.build_vocab(CollectionSentenceIterator(corpus))
        m.syn0, m.syn1, m.syn1neg = (jnp.asarray(x)
                                     for x in (syn0, syn1, syn1neg))
    else:
        import torch

        from deeplearning4j_tpu_torch.models import word2vec as w2v
        from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
            CollectionSentenceIterator,
        )

        m = w2v.Word2Vec(device="cpu", **cfg)
        m.build_vocab(CollectionSentenceIterator(corpus))
        st = w2v.word2vec_state_from_jax(syn0, syn1, syn1neg, device="cpu")
        m.syn0, m.syn1, m.syn1neg = st["syn0"], st["syn1"], st["syn1neg"]
    real = None
    if clip:  # the range flag forced to 1: saturated dots clipped
        from deeplearning4j_tpu_torch.ops import emb_dot

        real = emb_dot.fused_embedding_dot_range_plain
        emb_dot.fused_embedding_dot_range_plain = lambda h, w, mask: (
            real(h, w, mask)[0], torch.ones_like(mask))
    t0 = time.perf_counter()
    try:
        m.fit(CollectionSentenceIterator(corpus))
    finally:
        if real is not None:
            emb_dot.fused_embedding_dot_range_plain = real
    secs = time.perf_counter() - t0
    s0, s1 = np.asarray(m.syn0), np.asarray(m.syn1)
    top = np.abs(s0).max(1)
    return {"seconds": secs, "V": len(s0), "finite": bool(
        np.isfinite(s0).all()), "max_abs_syn0": float(top.max()),
        "max_row": int(top.argmax()),
        "max_abs_syn1": float(np.abs(s1).max())}, s0


def _apart(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a - b)
    return {"max_abs_diff": float(d.max()),
            "rows_over_1e-3": int((d.max(1) > 1e-3).sum())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sentences", type=int, default=4000)
    ap.add_argument("--perturb", type=float, default=None, metavar="EPS")
    ap.add_argument("--perturb-port", action="store_true")
    ap.add_argument("--clip", action="store_true")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from chip_smoke import W2V_SENT_LEN, W2V_TYPES, zipf_corpus

    corpus = zipf_corpus(args.sentences, W2V_SENT_LEN, W2V_TYPES)
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
    from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer

    tok = DefaultTokenizer()
    v = len(VocabCache().fit(tok.tokens(s) for s in corpus))
    rng = np.random.default_rng(0)
    syn0 = ((rng.random((v, D)) - 0.5) / D).astype(np.float32)

    out = {"sentences": args.sentences, "config": "D 100, window 5, "
           "batches of 4096, lr 0.025, HS, 1 epoch"}
    out["reference"], ref = _fit("reference", corpus, syn0)
    out["port"], port = _fit("port", corpus, syn0)
    out["port_vs_reference"] = _apart(port, ref)
    if args.perturb is not None:
        nudged = (syn0 * np.float32(1 + args.perturb)).astype(np.float32)
        out["reference_perturbed"], pert = _fit("reference", corpus, nudged)
        out["perturbed_vs_reference"] = _apart(pert, ref)
        if args.perturb_port:
            out["port_perturbed"], pport = _fit("port", corpus, nudged)
            out["port_perturbed_vs_port"] = _apart(pport, port)
    if args.clip:
        out["port_clip"], _ = _fit("port", corpus, syn0, clip=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
