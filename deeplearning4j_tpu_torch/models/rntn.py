"""Recursive Neural Tensor Network (Socher) over binarized trees — the port
of ``deeplearning4j_tpu/models/rntn.py``.

≙ reference models/rntn/RNTN.java:55-1392: composition
``h = f(W [l; r; 1] + [l; r]^T V [l; r])`` bottom-up over a binary tree,
per-node softmax classification, AdaGrad training, RNTNEval.

As the reference: the parameter tables carry a leading production axis
(``simplified_model=True``, the default, is the one shared matrix of the
reference's runnable mode; ``simplified_model=False`` keys W, V and the
binary classifier by the children's categories, and with
``combine_classification=False`` splits binary and unary classification),
and trees train in padded batches of ``(batch, max_nodes)`` node tables in
topological order. The reference runs a ``fori_loop`` over the slots of one
tree, ``vmap``ped over the batch; here one loop over the slots serves the
whole batch: slot i gathers the children of every tree's node i at once,
composes them, and selects ``tanh(emb[word])`` where the node is a leaf
(padding slots count as leaves; the node mask drops them from the loss).
The node table is rebuilt out of place at each slot, so autograd keeps
every slot. With one production the tensor term is one product against
``V[0]``; with several, V is gathered once a slot, (B, 2d, 2d, d), and
autograd keeps each gather (``max_nodes`` of them). The products run with
TF32 off (``dtypes.precision()``). The draws take the reference's keys
(``rng.py``).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch import rng as rng_lib
from deeplearning4j_tpu_torch.device import resolve_device, upload
from deeplearning4j_tpu_torch.nlp.tree import Tree
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


def basic_category(label: str, simplified: bool = True) -> str:
    """≙ RNTN.basicCategory:450 — "" collapses every label (flat model);
    the untied variant strips binarization markers (``@NP`` from the
    binarizer) and PTB functional annotations (``NP-SBJ=2`` -> ``NP``)."""
    if simplified:
        return ""
    return label.lstrip("@").split("-")[0].split("=")[0]


def topo_pack(tree: Tree, cache: VocabCache, num_classes: int):
    """Pack a binary tree into arrays for the slot loop.

    Returns (word_ids, left, right, is_leaf, labels) over nodes in
    topological (children-first) order. Leaf nodes reference embedding
    rows; internal nodes reference child slots.
    """
    p = _pack_full(tree, cache, num_classes)
    return p["word_ids"], p["left"], p["right"], p["leaf"], p["labels"]


def _pack_full(
    tree: Tree,
    cache: VocabCache,
    num_classes: int,
    prod_index: dict | None = None,
    unary_index: dict | None = None,
    simplified: bool = True,
):
    """topo_pack plus per-node production / unary-category indices.

    ``prod`` indexes the (left-cat, right-cat) production tables for
    internal nodes (≙ getBinaryTransform:472); ``ucat`` indexes the unary
    classification table by the node's own category
    (≙ getUnaryClassification:457), -1 on a binary node. Unseen keys fall
    back to slot 0.
    """
    nodes: list[Tree] = []

    def visit(t: Tree):
        for c in t.children:
            visit(c)
        nodes.append(t)

    visit(tree)
    n = len(nodes)
    index = {id(t): i for i, t in enumerate(nodes)}
    word_ids = np.zeros(n, np.int32)
    left = np.zeros(n, np.int32)
    right = np.zeros(n, np.int32)
    leaf = np.zeros(n, np.float32)
    labels = np.zeros(n, np.int32)
    prod = np.zeros(n, np.int32)
    ucat = np.zeros(n, np.int32)
    for i, t in enumerate(nodes):
        try:
            labels[i] = int(t.label.lstrip("@")) % num_classes
        except ValueError:
            labels[i] = 0
        if unary_index is not None:
            if len(t.children) == 2:
                # binary nodes classify through the production table
                # (getClassWForNode:400)
                ucat[i] = -1
            else:
                # leaves and one-child internal nodes classify by their own
                # category (≙ getUnaryClassification:457)
                ucat[i] = unary_index.get(
                    basic_category(t.label, simplified), 0
                )
        if t.is_leaf():
            leaf[i] = 1.0
            word_ids[i] = max(cache.index_of(t.word or ""), 0)
        else:
            left[i] = index[id(t.children[0])]
            right[i] = index[id(t.children[-1])]
            if prod_index is not None:
                key = (
                    basic_category(t.children[0].label, simplified),
                    basic_category(t.children[-1].label, simplified),
                )
                prod[i] = prod_index.get(key, 0)
    return dict(
        word_ids=word_ids, left=left, right=right, leaf=leaf,
        labels=labels, prod=prod, ucat=ucat,
    )


#: the packed fields of a padded tree, in the order of ``_pad``'s tuple
FIELDS = ("word_ids", "left", "right", "leaf", "labels", "mask", "prod",
          "ucat")


class RNTN:
    """The RNTN on ``device`` (``cuda`` unless the caller names another;
    raises without a card)."""

    def __init__(
        self,
        num_classes: int = 2,
        dim: int = 16,
        lr: float = 0.05,
        use_tensor: bool = True,
        seed: int = 123,
        max_nodes: int = 64,
        simplified_model: bool = True,
        combine_classification: bool = True,
        batch_size: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.dim = dim
        self.lr = lr
        self.use_tensor = use_tensor
        self.seed = seed
        self.max_nodes = max_nodes
        self.simplified_model = simplified_model
        self.combine_classification = combine_classification
        self.batch_size = batch_size
        self.cache = VocabCache()
        self.params: dict[str, torch.Tensor] | None = None
        self._adagrad: dict[str, torch.Tensor] | None = None
        # production / unary-category registries (slot 0 = fallback);
        # simplified mode keeps exactly the one ("","") production the
        # reference seeds at RNTN.java:202
        self.prod_index: dict[tuple[str, str], int] = {("", ""): 0}
        self.unary_index: dict[str, int] = {"": 0}

    # -- production discovery ----------------------------------------------
    def discover_productions(self, trees: Iterable[Tree]) -> None:
        """≙ the binaryProductions/unaryProductions discovery the reference
        left as a TODO (RNTN.java:205-219). No-op in simplified mode
        (everything is the "" category)."""
        if self.simplified_model:
            return
        for t in trees:
            for node in t.subtrees():
                cat = basic_category(node.label, False)
                if cat not in self.unary_index:
                    self.unary_index[cat] = len(self.unary_index)
                if node.children:
                    key = (
                        basic_category(node.children[0].label, False),
                        basic_category(node.children[-1].label, False),
                    )
                    if key not in self.prod_index:
                        self.prod_index[key] = len(self.prod_index)

    def _uniform(self, key, shape) -> torch.Tensor:
        """``jax.random.uniform(key, shape, minval=-r, maxval=r)``, r =
        1/sqrt(2d), on the model's device (the reference's bits)."""
        r = 1.0 / np.sqrt(2 * self.dim)
        return rng_lib.uniform(key, shape, -r, r, device=self.device)

    def init_params(self) -> None:
        """The reference's tables from ``split(key(seed), 6)``: W, V, Wc,
        Wc_bin and Wc_un uniform in +-1/sqrt(2d) (V times 0.0 without the
        tensor), the embeddings ``0.1 * normal``; AdaGrad history zero."""
        d, c, v = self.dim, self.num_classes, max(len(self.cache), 1)
        np_, nu = len(self.prod_index), len(self.unary_index)
        k = rng_lib.split(rng_lib.key_for(self.seed), 6)
        self.params = {
            "W": self._uniform(k[0], (np_, d, 2 * d + 1)),
            "V": self._uniform(k[1], (np_, 2 * d, 2 * d, d))
            * (1.0 if self.use_tensor else 0.0),
            "Wc": self._uniform(k[2], (c, d + 1)),
            "emb": 0.1 * rng_lib.normal(k[3], (v, d), device=self.device),
        }
        if not self.combine_classification:
            # ≙ binaryClassification (:251) + unaryClassification (:259)
            self.params["Wc_bin"] = self._uniform(k[4], (np_, c, d + 1))
            self.params["Wc_un"] = self._uniform(k[5], (nu, c, d + 1))
        self._adagrad = {n: torch.zeros_like(p)
                         for n, p in self.params.items()}

    def _grow_tables(self) -> None:
        """Extend the production/unary-keyed tables to the registry sizes,
        preserving trained slots; new slots draw from ``key(seed + 1)``
        (one split a grown table) like init_params and start with fresh
        AdaGrad history."""
        d, c = self.dim, self.num_classes
        targets = {
            "W": (len(self.prod_index), (d, 2 * d + 1)),
            "V": (len(self.prod_index), (2 * d, 2 * d, d)),
        }
        if not self.combine_classification:
            targets["Wc_bin"] = (len(self.prod_index), (c, d + 1))
            targets["Wc_un"] = (len(self.unary_index), (c, d + 1))
        key = rng_lib.key_for(self.seed + 1)
        for name, (n_new, shape) in targets.items():
            cur = self.params[name]
            if cur.shape[0] >= n_new:
                continue
            key, sub = rng_lib.split(key)
            fresh = self._uniform(sub, (n_new - cur.shape[0], *shape))
            if name == "V" and not self.use_tensor:
                fresh = fresh * 0.0
            self.params[name] = torch.cat([cur, fresh])
            self._adagrad[name] = torch.cat(
                [self._adagrad[name], torch.zeros_like(fresh)])

    # -- forward over the packed trees --------------------------------------
    def _node_vectors(self, params, word_ids, left, right, leaf, prod):
        """Every node's vector, (B, M, d): one step a slot for the whole
        batch, children gathered from the table of the slots so far."""
        bsz, m = word_ids.shape
        d = self.dim
        rows = torch.arange(bsz, device=word_ids.device)
        leaf_vecs = torch.tanh(params["emb"][word_ids])  # (B, M, d)
        is_leaf = leaf > 0
        ones = torch.ones((bsz, 1), device=leaf_vecs.device)
        one_prod = params["W"].shape[0] == 1
        vecs = torch.zeros((bsz, m, d), device=leaf_vecs.device)
        for i in range(m):
            lr2 = torch.cat([vecs[rows, left[:, i]], vecs[rows, right[:, i]]],
                            dim=-1)  # (B, 2d)
            lr_cat = torch.cat([lr2, ones], dim=-1)
            outer = (lr2[:, :, None] * lr2[:, None, :]).reshape(bsz, -1)
            if one_prod:
                linear = lr_cat @ params["W"][0].T
                tensor = outer @ params["V"][0].reshape(-1, d)
            else:
                p = prod[:, i]
                linear = torch.bmm(params["W"][p], lr_cat[:, :, None])[..., 0]
                tensor = torch.bmm(outer[:, None, :],
                                   params["V"][p].reshape(bsz, -1, d))[:, 0]
            vec = torch.where(is_leaf[:, i, None], leaf_vecs[:, i],
                              torch.tanh(linear + tensor))
            vecs = vecs.index_put((rows, torch.full_like(rows, i)), vec)
        return vecs

    def _node_logits(self, params, vecs, prod, ucat):
        d = self.dim
        if self.combine_classification:
            wc = params["Wc"]
            return vecs @ wc[:, :d].T + wc[:, d]
        # untied classification: binary nodes read the production table;
        # leaves and unary internal nodes read the category table — ucat ==
        # -1 marks binary nodes (≙ getClassWForNode:400)
        wsel = torch.where(
            (ucat >= 0)[..., None, None],
            params["Wc_un"][torch.clamp(ucat, min=0)],
            params["Wc_bin"][prod],
        )  # (B, M, c, d+1)
        return (vecs[..., None, :] * wsel[..., :d]).sum(-1) + wsel[..., d]

    def _tree_losses(self, params, batch):
        """Per-tree losses (the masked mean of the nodes' NLL), (B,), and
        the node logits (B, M, c)."""
        word_ids, left, right, leaf, labels, mask, prod, ucat = batch
        with dtypes.precision():
            vecs = self._node_vectors(params, word_ids, left, right, leaf,
                                      prod)
            logits = self._node_logits(params, vecs, prod, ucat)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels[..., None])[..., 0] * mask
        per_tree = nll.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
        return per_tree, logits

    def _batch_loss_and_grads(self, params, batch, tree_w):
        """The batch's loss (the mean per-tree loss weighted by ``tree_w``)
        and its gradient for every table (zeros for one the loss does not
        read)."""
        names = list(params)
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        p = dict(zip(names, leaves))
        with dtypes.precision():
            per_tree, _ = self._tree_losses(p, batch)
            loss = (per_tree * tree_w).sum() / torch.clamp(tree_w.sum(),
                                                           min=1.0)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(x) if g is None else g
                               for n, x, g in zip(names, leaves, grads)}

    def _batch_step(self, params, hist, batch, tree_w, lr: float):
        """One AdaGrad step on the batch's weighted mean per-tree loss:
        ``h += g^2``, ``p -= lr * g / (sqrt(h) + 1e-8)``. Returns (params,
        hist, loss)."""
        loss, grads = self._batch_loss_and_grads(params, batch, tree_w)
        hist = {n: hist[n] + grads[n] * grads[n] for n in params}
        params = {n: params[n] - lr * grads[n] / (torch.sqrt(hist[n]) + 1e-8)
                  for n in params}
        return params, hist, loss

    def _pad(self, packed: dict):
        """Pad packed tree arrays to max_nodes (one step shape)."""
        n = len(packed["word_ids"])
        m = self.max_nodes
        if n > m:
            raise ValueError(f"tree has {n} nodes > max_nodes={m}")
        pad = m - n
        mask = np.concatenate(
            [np.ones(n, np.float32), np.zeros(pad, np.float32)]
        )

        def ext(a, fill=0):
            return np.concatenate([a, np.full(pad, fill, a.dtype)])

        return (
            ext(packed["word_ids"]), ext(packed["left"]),
            ext(packed["right"]),
            ext(packed["leaf"], 1),  # pads act as leaves
            ext(packed["labels"]), mask,
            ext(packed["prod"]), ext(packed["ucat"]),
        )

    def _pack_padded(self, tree: Tree):
        return self._pad(
            _pack_full(
                tree, self.cache, self.num_classes,
                self.prod_index, self.unary_index, self.simplified_model,
            )
        )

    def _upload(self, cols) -> tuple[torch.Tensor, ...]:
        """Stacked packed fields on the model's device: indices int64, the
        leaf flags and the mask f32."""
        return tuple(
            upload(np.ascontiguousarray(
                c, np.float32 if name in ("leaf", "mask") else np.int64),
                self.device)
            for name, c in zip(FIELDS, cols))

    def fit_trees(
        self, trees: Iterable[Tree], epochs: int = 1,
        batch_size: int | None = None,
    ) -> list[float]:
        """≙ RNTN.fit:341: batches of padded trees, one AdaGrad step each;
        returns each epoch's mean loss (weighted by the real trees of each
        batch)."""
        trees = list(trees)
        if len(self.cache) == 0:
            self.cache.fit([t.words() for t in trees])
        self.discover_productions(trees)
        if self.params is None:
            self.init_params()
        else:
            # a later fit may register new productions/categories — the
            # tables must grow with the registries
            self._grow_tables()
        b = max(1, min(batch_size or self.batch_size, len(trees)))
        # pack once, train many epochs (trees are static); the last batch
        # is padded to the same B with zero-weight repeats of the first
        # tree
        packed = [self._pack_padded(t) for t in trees]
        n = len(trees)
        pad = (-n) % b
        cols = self._upload([np.stack(col + col[:1] * pad)
                             for col in (list(z) for z in zip(*packed))])
        weights = np.concatenate(
            [np.ones(n, np.float32), np.zeros(pad, np.float32)]
        )
        w_dev = upload(weights, self.device)
        lr = float(np.float32(self.lr))
        losses = []
        for _ in range(epochs):
            batch_losses = []
            for s in range(0, n + pad, b):
                batch = tuple(c[s:s + b] for c in cols)
                self.params, self._adagrad, loss = self._batch_step(
                    self.params, self._adagrad, batch, w_dev[s:s + b], lr)
                batch_losses.append(loss)
            # the reference's host sum: loss x the batch's real trees, in
            # order, in f64
            total, nw = 0.0, 0.0
            for s, loss in zip(range(0, n + pad, b),
                               torch.stack(batch_losses).double().tolist()):
                bw = float(weights[s:s + b].sum())
                total += loss * bw
                nw += bw
            losses.append(total / max(nw, 1.0))
        return losses

    def predict_root(self, tree: Tree) -> int:
        # the root is the last real node in topological order
        return int(self.predict_nodes(tree)[-1])

    def predict_nodes(self, tree: Tree) -> np.ndarray:
        """Per-node class predictions in topological order (real nodes
        only) — the node-level view RNTNEval.java:61 accumulates. Ties go to
        the lowest class, as ``jnp.argmax``'s."""
        padded = self._pack_padded(tree)
        batch = self._upload([a[None] for a in padded])
        with torch.no_grad():
            _, logits = self._tree_losses(self.params, batch)
        n_real = int(padded[5].sum())
        return torch.argmax(logits[0, :n_real], dim=-1).cpu().numpy()


class RNTNEval:
    """≙ RNTNEval.java:61 — accuracy over tree root labels."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    def eval(self, model: RNTN, trees: Iterable[Tree]) -> None:
        for t in trees:
            try:
                gold = int(t.label) % model.num_classes
            except ValueError:
                continue
            self.total += 1
            if model.predict_root(t) == gold:
                self.correct += 1

    def accuracy(self) -> float:
        return self.correct / self.total if self.total else 0.0


def params_from_jax(np_params: dict, device=None) -> dict[str, torch.Tensor]:
    """The JAX package's RNTN parameter dict (numpy arrays, or its AdaGrad
    history) as the port's f32 tensors on ``device`` (``cuda`` unless the
    caller names another; raises without a card), keyed and laid out as
    the reference's."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(x, np.float32), device=dev)
            for k, x in np_params.items()}


def params_to_jax(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's parameter dict as host numpy arrays in the reference's
    keys and layout."""
    return {k: t.detach().cpu().numpy().copy() for k, t in params.items()}
