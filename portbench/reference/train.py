"""FLMR's training step in plain float32 PyTorch: the towers
(reference/towers.py), each query's nway cross-entropy (its positive
first) plus the in-batch-negative cross-entropy over every doc of the
batch (query i's positive at column i * nway), and AdamW (decoupled decay,
bias-corrected moments; the mapping network's own learning rate).

Also how the program's data path lays out a batch, worked out again from
the raw data: the loader's seeded permutation of the questions, then per
question one of its positives at random and nway - 1 corpus passages that
are not its positives (RAVQA's sampler), from the dataset's own seeded
generator, in order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import tokenize, towers


def batches(world, vocab, cfg, loader_seed, data_seed, n_batches):
    """The first n_batches batches as the data path makes them:
    [(qids, qmask, feats, dids, dmask)] as numpy."""
    tr = cfg["train"]
    bsz, nway = tr["batch_size"], nway_of(cfg)
    order = np.random.default_rng(loader_seed).permutation(
        len(world.questions))
    rng = np.random.default_rng(data_seed)
    n = len(world.pids)
    out = []
    for b in range(n_batches):
        idx = order[b * bsz:(b + 1) * bsz]
        docs = []
        for i in idx:
            pos = world.pos_ids[i]
            docs.append(int(pos[rng.integers(len(pos))][3:]))
            pos_set = set(pos)
            for _ in range(nway - 1):
                j = int(rng.integers(n))
                while world.pids[j] in pos_set:
                    j = int(rng.integers(n))
                docs.append(j)
        qids, qmask = tokenize.queries([world.questions[i] for i in idx],
                                       vocab, cfg["query_maxlen"])
        dids, dmask = tokenize.docs([world.passages[j] for j in docs], vocab,
                                    cfg["doc_maxlen"])
        out.append((qids, qmask, world.features[idx], dids, dmask))
    return out


def nway_of(cfg: dict) -> int:
    """Docs a question: its positive and num_negative_samples negatives."""
    return cfg["model_config"]["num_negative_samples"] + 1


def maxsim_pairs(q, d, dmask):
    """(B, Lq, dim) x (D, Ld, dim) -> (B, D)."""
    s = towers.einsum("bqd,nld->bnlq", q, d)
    s = s.masked_fill(~dmask.bool()[None, :, :, None], -9999.0)
    return s.amax(dim=2).sum(dim=-1)


def loss(w, mc, nway, batch, half=False):
    """The nway + in-batch loss of a device batch; `half` takes the mean
    over the first half of the queries only (a planted fault)."""
    qids, qmask, feats, dids, dmask = batch
    q = towers.query(w, mc, qids, qmask, image_features=feats)
    d, keep = towers.doc(w, mc, dids, dmask)
    bsz = q.shape[0]
    if half:
        bsz //= 2
        q = q[:bsz]
    scores = maxsim_pairs(q, d, keep)                     # (B, B * nway)
    own = torch.stack([scores[i, i * nway:(i + 1) * nway]
                       for i in range(bsz)])
    zeros = torch.zeros(bsz, dtype=torch.long, device=q.device)
    labels = torch.arange(bsz, device=q.device) * nway
    nway_loss = F.cross_entropy(own, zeros)
    return nway_loss + F.cross_entropy(scores, labels)


class AdamW:
    def __init__(self, params: dict, lrs: dict, b1=0.9, b2=0.999, eps=1e-8,
                 wd=0.0):
        self.p, self.lrs = params, lrs
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads.get(k)
            if g is None:
                g = torch.zeros_like(p)
            lr = self.lrs[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / bc2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def groups(names) -> dict:
    """{leaf: "mapping" for the mapping network's, else "base"}."""
    return {k: ("mapping" if k.split(".")[0] == "vision_projection"
                else "base") for k in names}


def learning_rates(names, tr: dict) -> dict:
    """The mapping network's parameters take mapping_network_lr."""
    return {k: (tr["mapping_network_lr"] if g == "mapping" else tr["lr"])
            for k, g in groups(names).items()}


def run(weights: dict, cfg: dict, dev_batches: list, steps: int = 3,
        half: bool = False, precision: str = "float32") -> dict:
    """Train `steps` steps from `weights` (left untouched) ->
    {"loss": [...], "grad": {leaf: norm of step 1's gradient},
    "change": {leaf: norm of the change after `steps`},
    "group": {leaf: its learning-rate group}}."""
    mc, tr = cfg["model_config"], cfg["train"]
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.items()}
    opt = AdamW(p, learning_rates(p, tr))
    out = {"loss": [], "grad": {}, "change": {}, "group": groups(p)}
    with towers.precision(precision):
        for s in range(steps):
            for v in p.values():
                v.grad = None
            lv = loss(p, mc, nway_of(cfg), dev_batches[s], half)
            lv.backward()
            grads = {k: v.grad for k, v in p.items()}
            if s == 0:
                out["grad"] = {k: (0.0 if g is None else float(g.norm()))
                               for k, g in grads.items()}
            out["loss"].append(float(lv.detach()))
            opt.step(grads)
    out["change"] = {k: float((p[k].detach() - weights[k]).norm())
                     for k in p}
    return out
