"""View-serving driver (the paper's workload, LM-encoded), counterpart of
`repro.launch.view_driver`.

A classification view over a corpus of documents *encoded by an LM
backbone* (the port's tinyllama smoke twin: `forward(...,
return_hidden=True)`, through the `flash_attention` kernel on a GPU),
serving mixed read/update traffic — Single-Entity reads, All-Members
counts and streaming training examples — with `HazyEngine` maintaining
the view and SKIING deciding reorganizations.

Run:  PYTHONPATH=src python -m repro_torch.launch.view_driver \
          [--requests 3000] [--device cpu]

`--sql` (the same workload through the relational front end) waits for
`rdbms/` (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import clock


def make_backbone_encoder(arch: str = "tinyllama-1.1b", batch: int = 32, *,
                          params=None, device=None):
    """A reduced assigned-arch backbone as the HAZY feature function:
    mean-pooled final hidden state and mean-pooled token embeddings,
    each rounded to the model's dtype as the reference pools them, then
    every row normalized to unit length on the host. Runs `params` where
    given (`core.convert.params_from_reference` carries the reference's
    across), else weights drawn from seed 0, on `device` (None: the GPU).
    Returns (encode, cfg); encode maps (n, s) int tokens to (n, 2·d) f32."""
    from repro_torch.configs import smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build
    from repro_torch.models.steps import init_serving_params
    cfg = smoke_config(arch)
    mdl = build(cfg)
    dev = resolve_device(device)
    if params is None:
        params = init_serving_params(mdl, 0, dev)

    @torch.no_grad()
    def encode_batch(tokens):
        hidden, _ = mdl.forward(params, {"tokens": tokens}, return_hidden=True)
        emb = params["tok"]["embedding"][tokens.long()]
        pooled = [x.float().mean(1).to(hidden.dtype) for x in (hidden, emb)]
        return torch.cat(pooled, -1)

    def encode(docs_tokens: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, docs_tokens.shape[0], batch):
            tokens = torch.tensor(docs_tokens[i:i + batch], device=dev)
            out.append(encode_batch(tokens).float().cpu().numpy())
        F = np.concatenate(out)
        return F / np.maximum(np.linalg.norm(F, axis=1, keepdims=True), 1e-9)

    return encode, cfg


def make_topic_docs(cfg, n_docs: int, doc_len: int, seed: int = 0):
    """Two 'topics': docs drawn from distinct topical vocabularies (with
    some shared common words mixed in). Returns (docs_tokens, topic mask),
    bit for bit the reference's draws."""
    r = np.random.default_rng(seed)
    topic = r.random(n_docs) < 0.5
    v8 = cfg.vocab_size // 8
    topical = np.where(topic[:, None],
                       r.integers(0, v8, (n_docs, doc_len)),
                       r.integers(4 * v8, 5 * v8, (n_docs, doc_len)))
    common = r.integers(6 * v8, 8 * v8, (n_docs, doc_len))
    use_common = r.random((n_docs, doc_len)) < 0.3
    docs = np.where(use_common, common, topical).astype(np.int32)
    return docs, topic


def serve_view(requests: int = 3000, docs: int = 4000, doc_len: int = 32,
               device=None):
    """The classic driver: direct `ClassificationView` calls, hybrid
    policy, on `device` (None: the GPU). Ends in the golden invariant."""
    from repro_torch.core import ClassificationView
    r = np.random.default_rng(0)
    encode, cfg = make_backbone_encoder(device=device)
    tokens, topic = make_topic_docs(cfg, docs, doc_len)
    t0 = clock()
    F = encode(tokens)
    print(f"encoded {docs} docs with {cfg.name} backbone "
          f"in {clock()-t0:.1f}s -> features {F.shape}")

    view = ClassificationView(F, method="svm", policy="hybrid",
                              norm=(2.0, 2.0), lr=0.1, buffer_frac=0.01,
                              device=device)

    labels = np.where(topic, 1.0, -1.0)
    kinds = r.choice(["read", "members", "update"], size=requests,
                     p=[0.55, 0.05, 0.40])
    served = {"read": 0, "members": 0, "update": 0}
    t0 = clock()
    for kind in kinds:
        if kind == "read":
            view.label(int(r.integers(0, docs)))
        elif kind == "members":
            view.all_members()
        else:
            i = int(r.integers(0, docs))
            view.insert_example(i, float(labels[i]))
        served[kind] += 1
    dt = clock() - t0
    print(f"served {requests} requests in {dt:.2f}s "
          f"({requests/dt:.0f} req/s): {served}")
    eng = view.engine
    print(f"SKIING reorgs: {eng.skiing.reorgs}, "
          f"band now: {eng.band_fraction():.4f}")
    acc = np.mean([view.label(i) == labels[i] for i in range(0, docs, 7)])
    print(f"classification agreement with topic labels: {acc:.3f}")
    if not eng.check_consistent():
        raise AssertionError("view labels != sign(F·w − b) under the "
                             "current model")
    print("view exact ✓")
    return view


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3000)
    ap.add_argument("--docs", type=int, default=4000)
    ap.add_argument("--doc-len", type=int, default=32)
    ap.add_argument("--sql", action="store_true",
                    help="drive the workload through the SQL front-end")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.sql:
        raise NotImplementedError("--sql is not ported yet: ROADMAP.md "
                                  "Queue 1 item 7 (rdbms/)")
    return serve_view(args.requests, args.docs, args.doc_len,
                      device=args.device)


if __name__ == "__main__":
    main()
