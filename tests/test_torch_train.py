"""The port's trainer and training forward against the JAX package's.

- make_schedule against the JAX package's (optax) at every update count;
- make_optimizer against the JAX package's optax chain over several
  updates, on the same gradients: mapping-LR groups, clipping, weight
  decay, accumulation, freeze flags (frozen parameters bit-identical and
  without state), a parameter no gradient reaches;
- FLMRRetriever.forward and the port's entry() against JAX __call__ and
  __graft_entry__.entry() on carried parameters (models.convert);
- remat on and off give the same gradients (as tests/test_remat.py);
- the JAX and the port executors' losses over 6 steps of
  configs/synthetic_flmr.json, from the same parameters and batches.

Tolerances: schedules rtol 1e-6, atol 1e-6 x lr (optax evaluates in
float32, and its float32 cosine is off by ~1e-11 near the decay's end). Optimizer
parameters rtol 1e-5, atol 1e-6 (Adam on O(1) random grads; both sides
float32). Forward values rtol 1e-5, atol 1e-5 (tests/test_torch_models.py's tower
tolerance; a loss sums several such values); grads rtol 1e-4 and atol 1e-5
times the largest grad of the model (the attention key biases' grads are 0
in exact arithmetic and ~1e-8 of rounding on either side). entry() at BERT-base: rtol
1e-4 (12 layers of 768-wide float32 reductions). Executor losses and
grad norms rtol 1e-4 (measured within 1e-5 over the 6 steps); parameters
after them only within 2 lr a step: Adam turns the towers' ~1e-7 float32
differences on near-zero gradient coordinates into updates up to lr apart.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ravqa_tpu.executors import base as jbase
from ravqa_tpu.models import flmr as jflmr
from ravqa_tpu_torch.executors import base as tbase
from ravqa_tpu_torch.models import (BertConfig, BertModel, FLMRModelConfig,
                                    FLMRRetriever, flax_to_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_flmr.json")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0, 1, 6])
@pytest.mark.parametrize("accum", [1, 2, 4])
def test_make_schedule_matches_optax(schedule, warmup, accum):
    cfg = dict(schedule=schedule, warmup_steps=warmup, total_steps=22,
               accumulate_grad_batches=accum)
    want = jbase.make_schedule(jbase.TrainConfig(**cfg), 3e-4)
    got = tbase.make_schedule(tbase.TrainConfig(**cfg), 3e-4)
    for count in range(30):
        w = float(want(count)) if callable(want) else float(want)
        np.testing.assert_allclose(got(count), w, rtol=1e-6, atol=3e-10)
    if warmup:
        assert got(0) == 0.0                      # update 0 takes lr(0)


def test_cosine_schedule_without_decay_steps_raises_like_optax():
    cfg = dict(schedule="cosine", warmup_steps=8, total_steps=8)
    with pytest.raises(ValueError, match="decay_steps"):
        jbase.make_schedule(jbase.TrainConfig(**cfg), 1e-3)
    with pytest.raises(ValueError, match="decay_steps"):
        tbase.make_schedule(tbase.TrainConfig(**cfg), 1e-3)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SHAPES = {"doc_encoder": {"w": (4, 3), "b": (3,)},
          "vision_projection": {"mlp": (5, 2)},
          "linear": {"w": (3, 2)},
          "pooler": {"w": (2, 2)}}            # no gradient reaches it


class _Params(nn.Module):
    """Parameters named like SHAPES ("doc_encoder.w", ...)."""

    def __init__(self, values: dict):
        super().__init__()
        for top, leaves in values.items():
            sub = nn.Module()
            for name, v in leaves.items():
                sub.register_parameter(name, nn.Parameter(
                    torch.tensor(v)))
            self.add_module(top, sub)


def _values(seed):
    rng = np.random.default_rng(seed)
    return {t: {n: rng.normal(size=s).astype(np.float32)
                for n, s in leaves.items()} for t, leaves in SHAPES.items()}


OPT_CASES = {
    "plain": dict(lr=1e-2),
    "groups_linear_wd": dict(lr=1e-2, mapping_lr=5e-2, schedule="linear",
                             warmup_steps=2, total_steps=8,
                             weight_decay=0.1),
    "clip_cosine": dict(lr=1e-2, grad_clip=0.5, schedule="cosine",
                        warmup_steps=2, total_steps=10),
    "accum2_clip": dict(lr=1e-2, accumulate_grad_batches=2, grad_clip=1.0,
                        warmup_steps=2, total_steps=12, schedule="linear",
                        weight_decay=0.05),
    "freeze": dict(lr=1e-2, mapping_lr=1e-1, weight_decay=0.1,
                   modules=("freeze_mapping_network",
                            "freeze_colbert_doc_encoder")),
    "freeze_accum": dict(lr=1e-2, accumulate_grad_batches=3,
                         modules=("freeze_mapping_network",)),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_make_optimizer_matches_optax(case):
    kw = OPT_CASES[case]
    jcfg, tcfg = jbase.TrainConfig(**kw), tbase.TrainConfig(**kw)
    params = _values(0)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = jbase.make_optimizer(jcfg, jparams)
    state = tx.init(jparams)
    module = _Params(params)
    opt = tbase.make_optimizer(tcfg, module)
    named = dict(module.named_parameters())
    rng = np.random.default_rng(1)
    for _ in range(6 * max(tcfg.accumulate_grad_batches, 1)):
        grads = {t: {n: (rng.normal(size=s).astype(np.float32) * 3
                         if t != "pooler" else np.zeros(s, np.float32))
                     for n, s in leaves.items()}
                 for t, leaves in SHAPES.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in named.items():
            top, leaf = name.split(".")
            p.grad = None if top == "pooler" else torch.tensor(
                grads[top][leaf])
        opt.step()
        for name, p in named.items():
            top, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[top][leaf]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    frozen = {n for n, t in tbase.trainable_mask(module, tcfg.modules)
              .items() if not t}
    assert frozen == {n for n in named if any(
        f in tcfg.modules for f, pre in (
            ("freeze_mapping_network", "vision_projection"),
            ("freeze_colbert_doc_encoder", "doc_encoder"),
            ("freeze_colbert_doc_encoder", "linear"))
        if n.startswith(pre))}
    state_ids = {id(p) for p in opt.adamw.state}
    for name in frozen:                     # untouched and stateless
        np.testing.assert_array_equal(
            named[name].detach().numpy(),
            params[name.split(".")[0]][name.split(".")[1]])
        assert id(named[name]) not in state_ids
    for name in set(named) - frozen:
        assert id(named[name]) in state_ids
    if opt.acc is not None:
        assert len(opt.acc) == len(named) - len(frozen)


class _Quad(tbase.BaseExecutor):
    """loss = mean((w - batch)^2) on one parameter vector."""

    def loss_fn(self, batch, generator):
        return ((self.model.w - batch) ** 2).mean(), {}


def _quad(cfg, **kw):
    m = nn.Module()
    m.w = nn.Parameter(torch.zeros(4))
    return _Quad(m, cfg, device="cpu", quiet=True, **kw)


def test_accumulation_matches_large_batch():
    """accumulate_grad_batches 4 over micro-batches of 2 = one step on the
    batch of 8 (tests/test_grad_accum.py); no update in between."""
    data = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 4)).astype(np.float32))
    ex = _quad(tbase.TrainConfig(lr=0.1, accumulate_grad_batches=4))
    snaps = []
    for i in range(4):
        ex.train_step(data[2 * i:2 * i + 2])
        snaps.append(ex.model.w.detach().clone())
    for s in snaps[:3]:
        assert torch.equal(s, torch.zeros(4))
    assert not torch.equal(snaps[3], torch.zeros(4))
    big = _quad(tbase.TrainConfig(lr=0.1))
    big.train_step(data)
    torch.testing.assert_close(big.model.w.detach(), snaps[3], rtol=1e-5,
                               atol=1e-6)
    assert ex.optimizer.updates == 1 and ex.step == 4


def test_grad_norm_counts_frozen_grads():
    """metrics["grad_norm"] is the norm of every grad of the micro-step. A
    frozen parameter takes none (the executor sets its requires_grad
    False, so autograd computes no weight grad for a frozen tower): it
    counts as zero, and the norm is the trainable parameters'. The JAX
    train step's optax.global_norm also counts the frozen grads (ROADMAP.md
    C21); the trainable grads and the update are the same in both."""
    values = _values(3)
    module = _Params(values)

    class Ex(tbase.BaseExecutor):
        def loss_fn(self, batch, generator):
            return sum((p ** 2).sum() for p in self.model.parameters()), {}

    ex = Ex(module, tbase.TrainConfig(modules=("freeze_mapping_network",)),
            device="cpu", quiet=True)
    m = ex.train_step(None)
    frozen = module.vision_projection.mlp
    assert not frozen.requires_grad and frozen.grad is None
    assert all(p.requires_grad for n, p in module.named_parameters()
               if not n.startswith("vision_projection"))
    want = np.sqrt(sum((2 * v ** 2).sum() * 2
                       for top, leaves in values.items()
                       if top != "vision_projection"
                       for v in leaves.values()))
    np.testing.assert_allclose(float(m["grad_norm"]), want, rtol=1e-5)


def test_inference_only_executor_has_no_optimizer():
    ex = _quad(None, inference_only=True)
    assert ex.inference_only and ex.optimizer is None
    with pytest.raises(RuntimeError, match="inference_only"):
        ex.train_step(torch.zeros(1, 4))
    assert not _quad(None).inference_only


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _batch(rng, cfg, b, lq, ld, nway):
    vocab = cfg.bert.vocab_size
    qi = rng.integers(5, vocab, (b, lq)).astype(np.int32)
    qm = np.ones((b, lq), np.int32)
    qm[0, lq - 3:] = 0
    qi[0, lq - 3:] = 0
    di = rng.integers(5, vocab, (b * nway, ld)).astype(np.int32)
    dm = np.ones((b * nway, ld), np.int32)
    for r in range(b * nway):
        n = int(rng.integers(2, ld + 1))
        dm[r, n:] = 0
        di[r, n:] = 0
    return dict(query_input_ids=qi, query_attention_mask=qm,
                image_features=rng.normal(size=(b, cfg.vision_dim)).astype(
                    np.float32),
                doc_input_ids=di, doc_attention_mask=dm)


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("input_ids")
            else torch.from_numpy(v) for k, v in batch.items()}


def _jax_cfg(cfg: FLMRModelConfig):
    fields = {f.name for f in dataclasses.fields(jflmr.FLMRModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg).items()
          if k in fields and k != "bert"}
    bert = {k: v for k, v in dataclasses.asdict(cfg.bert).items()}
    return jflmr.FLMRModelConfig(bert=jflmr.BertConfig(**bert), **kw)


FORWARD_CASES = {
    "ib": dict(),
    "no_ib": dict(use_ib_negatives=False),
    "ib_blocked": dict(ib_block_n=3),
    "nway3_flipr": dict(nway=3, interaction="flipr",
                        flipr_query_part_len=6, flipr_k1=4, flipr_k2=3),
    "separate_question_encoder": dict(separate_question_encoder=True),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_matches_jax(case):
    cfg = FLMRModelConfig.tiny(**FORWARD_CASES[case])
    jm = jflmr.FLMRRetriever(_jax_cfg(cfg))
    batch = _batch(np.random.default_rng(0), cfg, 3, 8, 10, cfg.nway)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init(jax.random.PRNGKey(0), **jb)["params"]

    def jloss(p):
        out = jm.apply({"params": p}, **jb)
        return out["loss"], out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tmod = FLMRRetriever(cfg)
    tmod.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    out = tmod(**_to_torch(batch))
    out["loss"].backward()
    for key in ("loss", "ib_loss", "scores"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(jout[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    want = flax_to_state_dict(jax.device_get(jgrads))
    names = dict(tmod.named_parameters())
    assert set(want) == set(names)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        got = names[name].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.fixture(scope="module")
def jax_entry():
    import __graft_entry__
    fn, (params, batch) = __graft_entry__.entry()
    return float(jax.jit(fn)(params, batch)), jax.device_get(params), batch


def test_entry_matches_graft_entry(jax_entry):
    """The port's entry() at its BERT-base shape: the same batch as
    __graft_entry__.entry(), and on the JAX parameters the same loss."""
    from ravqa_tpu_torch.entry import entry
    want, params, jbatch = jax_entry
    fn, (model, batch) = entry(device="cpu")
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v))
    model.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = fn(model, batch).item()
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_bert_remat_grad_parity(dropout):
    """remat recomputes each layer in the backward and changes nothing:
    the same loss and grads, dropout masks included (each layer's masks
    come from its own seed, drawn once per forward)."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        1, 128, (2, 8)))
    am = torch.ones(2, 8, dtype=torch.int32)
    m0 = BertModel(BertConfig.tiny(vocab_size=128, dropout_rate=dropout))
    m1 = BertModel(BertConfig.tiny(vocab_size=128, dropout_rate=dropout,
                                   remat=True))
    m1.load_state_dict(m0.state_dict())
    proj = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(1))
    losses = []
    for m in (m0, m1):
        h = m(ids, am, deterministic=dropout == 0.0,
              generator=torch.Generator().manual_seed(3))[0]
        loss = (h * proj).sum()
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for (n, a), b in zip(m0.named_parameters(), m1.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6,
                                   msg=n)
    if dropout:                  # dropout was live: not the plain forward
        with torch.no_grad():
            plain = (m0(ids, am)[0] * proj).sum().item()
        assert plain != pytest.approx(losses[0], rel=1e-4)


def test_executor_loss_trajectory_matches_jax(tmp_path):
    """6 train steps of configs/synthetic_flmr.json (lr 2e-3, nway 2 with
    in-batch negatives) from the JAX executor's parameters, on the JAX
    loader's batches: the same loss, nway loss and IB loss each step."""
    from ravqa_tpu import main as jax_main
    from ravqa_tpu.config import load_config as jax_load_config
    from ravqa_tpu_torch import main as torch_main
    from ravqa_tpu_torch.config import load_config
    cfg = jax_load_config(CONFIG)
    data = jax_main.build_pipeline(cfg, cache_dir=None).get_data(
        cfg.data_pipeline_output_node, explode=True)
    jex = jax_main.build_executor(cfg, data, None, str(tmp_path / "j"),
                                  quiet=True)
    tex = torch_main.build_executor(load_config(CONFIG), "cpu")
    tex.model.load_state_dict(flax_to_state_dict(
        jax.device_get(jex.state.params)))
    loader = data["train"].loader(batch_size=8, shuffle=True, seed=0)
    for _ in range(6):
        batch = next(loader)
        jm = jex.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        tm = tex.train_step(batch)
        for key in ("loss", "nway_loss", "ib_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
    # parameters: Adam moves a coordinate by about lr a step whatever its
    # gradient's size, so near-zero gradients that differ in their float32
    # rounding part parameters by up to ~lr a step (measured 0.0055 after
    # 6 steps at lr 2e-3); more than 2 lr a step would be a wrong update
    want = flax_to_state_dict(jax.device_get(jex.state.params))
    for name, p in tex.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=6 * 2 * 2e-3, err_msg=name)
