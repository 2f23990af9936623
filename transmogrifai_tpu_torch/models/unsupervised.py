"""Unsupervised text models: LDA topics and word embeddings, on the device.

Counterpart of ``transmogrifai_tpu/models/unsupervised.py`` (reference:
core/.../impl/feature/OpLDA.scala, OpWord2Vec.scala wrapping Spark MLlib
LDA / Word2Vec):

* ``OpLDA`` - batch variational EM on the dense [n_docs, vocab] count
  matrix in float32 on the estimator's ``device``: each E-step is the
  [n, k, v] responsibility product, each M-step one reduction over the
  documents.  The initial topics are ``jax.random.dirichlet``'s draw
  (the port's ``utils/threefry.dirichlet``).  ``OpLDAModel`` infers a
  document's topic mixture with 20 E-steps on its ``device``.
* ``OpWord2Vec`` - skip-gram with negative sampling: the (center, context)
  pairs, the negatives and the initial vectors are drawn with numpy,
  seeded as in the JAX package; the SGD steps run on the device, each
  table update a summed ``index_add_`` whose row norms are clipped.
  ``OpWord2VecModel`` averages a row's token vectors on the host.
"""
from __future__ import annotations

from collections import Counter
from typing import Sequence

import numpy as np
import torch

from ..stages.base import Estimator, Transformer
from ..types.columns import Column, ListColumn, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import OPVector, TextList
from ..types.vector_metadata import VectorColumnMeta, VectorMetadata
from ..utils import threefry
from ..utils.device import resolve_device


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------
def _responsibilities(gamma, topics):
    """Each (document, topic, word)'s responsibility [n, k, v]: the
    expected topic share times the topic's word probability, normalised
    over topics."""
    e_theta = gamma / gamma.sum(dim=1, keepdim=True)
    weights = e_theta[:, :, None] * topics[None, :, :]
    return weights / torch.clamp(weights.sum(dim=1, keepdim=True), min=1e-12)


def _e_steps(gamma, topics, counts, alpha, e_steps: int):
    """``e_steps`` variational E-steps: the new document-topic counts are
    alpha plus each document's responsibility-weighted word counts."""
    for _ in range(e_steps):
        gamma = alpha + (_responsibilities(gamma, topics)
                         * counts[:, None, :]).sum(dim=2)
    return gamma


def _gamma0(counts, k: int):
    return torch.ones((counts.shape[0], k), dtype=counts.dtype,
                      device=counts.device) + counts.sum(dim=1, keepdim=True) / k


def lda_em_core(counts, topics, alpha: float, eta: float, iters: int = 30,
                e_steps: int = 10):
    """Variational EM for LDA from the initial ``topics`` [k, v] over
    ``counts`` [n, v] (float32 tensors on one device).  Returns the
    topics [k, v]."""
    gamma0 = _gamma0(counts, topics.shape[0])
    for _ in range(iters):
        gamma = _e_steps(gamma0, topics, counts, alpha, e_steps)
        new = eta + (_responsibilities(gamma, topics)
                     * counts[:, None, :]).sum(dim=0)
        topics = new / new.sum(dim=1, keepdim=True)
    return topics


def lda_infer_core(counts, topics, alpha: float, e_steps: int = 20):
    """Each document's topic mixture [n, k] under fitted ``topics``."""
    gamma = _e_steps(_gamma0(counts, topics.shape[0]), topics, counts, alpha,
                     e_steps)
    return gamma / gamma.sum(dim=1, keepdim=True)


def initial_topics(seed: int, k: int, v: int) -> np.ndarray:
    """The JAX package's initial topics: ``jax.random.dirichlet(
    PRNGKey(seed), ones(v), (k,))``, float32 [k, v]."""
    return threefry.dirichlet(threefry.prng_key(int(seed)), np.ones(v), (k,))


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32), device=dev)


class OpLDAModel(Transformer):
    """Fitted topics; ``device`` is where a transform infers mixtures."""

    input_types = [OPVector]
    output_type = OPVector

    def __init__(self, topics: np.ndarray, alpha: float,
                 device: str = "cuda", **kw) -> None:
        super().__init__(**kw)
        self.topics = np.asarray(topics)
        self.alpha = alpha
        self.device = str(device)

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (vec,) = cols
        assert isinstance(vec, VectorColumn)
        dev = resolve_device(self.device)
        theta = lda_infer_core(_f32(vec.values, dev), _f32(self.topics, dev),
                               float(np.float32(self.alpha))).cpu().numpy()
        feat = self.input_features[0]
        meta = VectorMetadata(
            self.output_name,
            tuple(
                VectorColumnMeta(feat.name, feat.ftype.type_name(),
                                 descriptor_value=f"topic_{i}")
                for i in range(theta.shape[1])
            ),
        ).reindexed()
        return VectorColumn(theta.astype(np.float32), meta)


class OpLDA(Estimator):
    """Topic model over a term-count vector (reference: OpLDA.scala; k
    default 10, maxIter)."""

    input_types = [OPVector]
    output_type = OPVector

    def __init__(self, k: int = 10, max_iter: int = 30, alpha: float = 1.1,
                 eta: float = 1.01, seed: int = 42, device: str = "cuda",
                 **kw) -> None:
        super().__init__(**kw)
        self.k = k
        self.max_iter = max_iter
        self.alpha = alpha
        self.eta = eta
        self.seed = seed
        self.device = str(device)

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        (vec,) = cols
        assert isinstance(vec, VectorColumn)
        dev = resolve_device(self.device)
        counts = np.asarray(vec.values)
        init = initial_topics(self.seed, self.k, counts.shape[1])
        topics = lda_em_core(_f32(counts, dev), _f32(init, dev),
                             float(np.float32(self.alpha)),
                             float(np.float32(self.eta)),
                             iters=self.max_iter)
        return OpLDAModel(topics.cpu().numpy(), self.alpha,
                          device=self.device)


# ---------------------------------------------------------------------------
# Word2Vec (skip-gram negative sampling)
# ---------------------------------------------------------------------------
def w2v_sgns_core(centers, contexts, negatives, in_emb, out_emb, steps: int,
                  lr: float = 0.05, clip_norm: float = 1.0):
    """``steps`` SGD steps over precomputed index batches (int64 tensors
    [B, b], [B, b], [B, b, neg]; step i takes batch i mod B) of the input
    and output tables [v, dim] (float32, on one device).  Each table's
    update is the batch's summed per-row gradient with its L2 norm capped
    at ``clip_norm``: on a tiny vocabulary a token repeats ~b/v times per
    batch and the plain sum diverges.  Returns the input table."""

    def scatter_clipped(tbl, ids, grads):
        upd = torch.zeros_like(tbl).index_add_(0, ids, grads)
        norm = torch.linalg.vector_norm(upd, dim=1, keepdim=True)
        upd = upd * torch.clamp(clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
        return tbl - lr * upd

    nb = centers.shape[0]
    for i in range(steps):
        c, ctx, neg = centers[i % nb], contexts[i % nb], negatives[i % nb]
        vc = in_emb[c]                                           # [b, d]
        vo = out_emb[ctx]                                        # [b, d]
        vn = out_emb[neg]                                        # [b, nk, d]
        pos = torch.sigmoid((vc * vo).sum(-1))
        negs = torch.sigmoid((vn @ vc[:, :, None])[..., 0])      # [b, nk]
        g_pos = (pos - 1.0)[:, None]
        g_neg = negs[..., None]
        grad_vc = g_pos * vo + (g_neg * vn).sum(dim=1)
        grad_vo = g_pos * vc
        grad_vn = g_neg * vc[:, None, :]
        in_emb = scatter_clipped(in_emb, c, grad_vc)
        out_emb = scatter_clipped(out_emb, ctx, grad_vo)
        out_emb = scatter_clipped(out_emb, neg.reshape(-1),
                                  grad_vn.reshape(-1, grad_vn.shape[-1]))
    return in_emb


class OpWord2VecModel(Transformer):
    input_types = [TextList]
    output_type = OPVector

    def __init__(self, vocab: dict, vectors: np.ndarray, **kw) -> None:
        super().__init__(**kw)
        self.vocab = dict(vocab)
        self.vectors = np.asarray(vectors)

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (col,) = cols
        assert isinstance(col, ListColumn)
        d = self.vectors.shape[1]
        out = np.zeros((len(col), d), dtype=np.float32)
        for i, toks in enumerate(col.values):
            idxs = [self.vocab[t] for t in toks if t in self.vocab]
            if idxs:
                out[i] = self.vectors[idxs].mean(axis=0)
        feat = self.input_features[0]
        meta = VectorMetadata(
            self.output_name,
            tuple(
                VectorColumnMeta(feat.name, feat.ftype.type_name(),
                                 descriptor_value=f"w2v_{j}")
                for j in range(d)
            ),
        ).reindexed()
        return VectorColumn(out, meta)

    def similar_words(self, word: str, top_k: int = 5) -> list[tuple[str, float]]:
        if word not in self.vocab:
            return []
        v = self.vectors[self.vocab[word]]
        norms = np.linalg.norm(self.vectors, axis=1) * (np.linalg.norm(v) + 1e-12)
        sims = self.vectors @ v / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        inv = {i: w for w, i in self.vocab.items()}
        return [
            (inv[i], float(sims[i])) for i in order if inv[i] != word
        ][:top_k]


class OpWord2Vec(Estimator):
    """Skip-gram negative-sampling embeddings (reference: OpWord2Vec.scala;
    vectorSize default 100, minCount 5, windowSize 5)."""

    input_types = [TextList]
    output_type = OPVector

    def __init__(self, vector_size: int = 100, min_count: int = 5,
                 window_size: int = 5, num_negatives: int = 5,
                 steps: int = 2000, batch: int = 256, seed: int = 42,
                 device: str = "cuda", **kw) -> None:
        super().__init__(**kw)
        self.vector_size = vector_size
        self.min_count = min_count
        self.window_size = window_size
        self.num_negatives = num_negatives
        self.steps = steps
        self.batch = batch
        self.seed = seed
        self.device = str(device)

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        (col,) = cols
        assert isinstance(col, ListColumn)
        dev = resolve_device(self.device)
        counts: Counter = Counter()
        for toks in col.values:
            counts.update(toks)
        vocab = {
            w: i
            for i, (w, c) in enumerate(
                sorted(counts.items(), key=lambda wc: (-wc[1], wc[0]))
            )
            if c >= self.min_count
        }
        if not vocab:
            return OpWord2VecModel({}, np.zeros((0, self.vector_size)))
        rng = np.random.RandomState(self.seed)
        pairs = []
        for toks in col.values:
            idxs = [vocab[t] for t in toks if t in vocab]
            for i, c in enumerate(idxs):
                lo = max(0, i - self.window_size)
                hi = min(len(idxs), i + self.window_size + 1)
                for j in range(lo, hi):
                    if j != i:
                        pairs.append((c, idxs[j]))
        if not pairs:
            return OpWord2VecModel(vocab,
                                   np.zeros((len(vocab), self.vector_size)))
        pairs_arr = np.array(pairs, dtype=np.int32)
        n_batches = max(1, len(pairs_arr) // self.batch)
        take = n_batches * self.batch
        order = rng.permutation(len(pairs_arr))[:take]
        centers = pairs_arr[order, 0].reshape(n_batches, self.batch)
        contexts = pairs_arr[order, 1].reshape(n_batches, self.batch)
        negatives = rng.randint(
            0, len(vocab), size=(n_batches, self.batch, self.num_negatives)
        ).astype(np.int32)
        v = len(vocab)
        init_in = rng.randn(v, self.vector_size).astype(np.float32) * 0.1
        # clip scale: a legitimate aggregate row update grows ~sqrt(batch)
        # in the summed scatter and ~sqrt(dim) in per-component count; 1.0
        # is calibrated for the (256, 100) defaults
        clip = max(
            1.0,
            float(np.sqrt((self.batch / 256.0) * (self.vector_size / 100.0))),
        )

        def idx(a):
            return torch.tensor(a.astype(np.int64), device=dev)

        in_emb = w2v_sgns_core(
            idx(centers), idx(contexts), idx(negatives),
            torch.tensor(init_in, device=dev),
            torch.zeros((v, self.vector_size), dtype=torch.float32, device=dev),
            steps=min(self.steps, n_batches * 50), clip_norm=clip,
        )
        return OpWord2VecModel(vocab, in_emb.cpu().numpy())
