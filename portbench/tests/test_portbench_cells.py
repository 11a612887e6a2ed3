"""Every cell, run through the harness on the CPU at tiny widths: the
program's answers against the plain reference, and faults planted in the
timed path, each of which must make `correct` false."""

import pytest
import torch

from portbench import judge
from portbench.tests import _tiny


@pytest.mark.parametrize("cell", sorted(_tiny.TINY))
def test_cell_is_correct_at_tiny_widths(cell):
    from portbench.spec import Cell
    r = _tiny.run(cell)
    assert r["correct"], r["checked"]
    assert r["failed"] == 0 and r["attempted"] > 0
    for name, c in r["checked"].items():
        assert c["value"] <= c["limit"], (name, c)
    # every end-to-end metric that BENCHMARK.json gives the cell
    assert set(r["metrics"]) == {m["name"] for m in Cell(cell).end_to_end}
    assert list(r)[-1] == "checked"


@pytest.mark.parametrize("cell", sorted(_tiny.TINY))
def test_traced_run_reports_the_host_side_metrics(cell):
    """With --trace 1 on the CPU (no device trace), every per-layer metric
    read from the host's records is there: mfu and the cell's own."""
    from portbench.spec import Cell
    host = {m["name"] for m in Cell(cell).per_layer
            if m["source"] != "device_trace"}
    r = _tiny.run(cell, trace=True)
    assert r["correct"], r["checked"]
    assert host and host <= set(r["metrics"]), (host, r["metrics"])


def _swap_answer(server):
    """The search returns another doc in place of each query's best one
    (with its score kept): an answer altered where it is produced."""
    search = server.searcher.search_device

    def altered(q, k):
        s, rows = search(q, k)
        rows = rows.clone()
        rows[:, 0] = (rows[:, 0] + 1) % server.searcher.index.num_docs
        return s, rows

    server.searcher.search_device = altered


def _nudge_score(server):
    """The search returns each best score a little high."""
    search = server.searcher.search_device

    def altered(q, k):
        s, rows = search(q, k)
        return s + 0.05, rows

    server.searcher.search_device = altered


def _plain_affine(server):
    """Every bias of the query tower zero and every LayerNorm weight one,
    as a fused epilogue that drops them would compute."""
    from portbench.reference import towers
    mc = server.pb_model_config
    scale = {n for n, _, kind in towers.param_specs(mc) if kind == "scale"}
    with torch.no_grad():
        for name, p in server.ex.model.named_parameters():
            if name in scale:
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()


@pytest.mark.parametrize("cell", ["flmr_exact_burst", "preflmr_hier_burst"])
@pytest.mark.parametrize("fault", [_swap_answer, _nudge_score,
                                   _plain_affine])
def test_serve_fault_fails(cell, fault, monkeypatch):
    from portbench.cells import flmr_serve as serve
    build = serve.build

    def broken(cell_, *a, **kw):
        server, state = build(cell_, *a, **kw)
        server.pb_model_config = cell_.cfg["model_config"]
        fault(server)
        return server, state

    monkeypatch.setattr(serve, "build", broken)
    r = _tiny.run(cell)
    assert not r["correct"], r["checked"]


def _unchanged(ex):
    """A step that returns its state unchanged: no update is applied."""
    ex.optimizer.step = lambda: True


def _half_batch(ex):
    """The loss over the first half of the batch's queries only."""
    loss_fn = ex.loss_fn

    def half(batch, generator):
        b = len(batch["query_input_ids"]) // 2
        nway = ex.model.cfg.nway
        cut = {k: (v[:b] if k.startswith("query") or k == "image_features"
                   else v[:b * nway]) for k, v in batch.items()}
        return loss_fn(cut, generator)

    ex.loss_fn = half


def _mapping_lr(ex):
    """The mapping network's group stepped at the base learning rate."""
    opt = ex.optimizer
    opt.schedules = [opt.schedules[0]] * len(opt.schedules)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _mapping_lr])
def test_train_fault_fails(fault, monkeypatch):
    from portbench.cells import flmr_train as train
    build = train.build

    def broken(*a, **kw):
        ex, it, state = build(*a, **kw)
        fault(ex)
        return ex, it, state

    monkeypatch.setattr(train, "build", broken)
    r = _tiny.run("flmr_train")
    assert not r["correct"], r["checked"]


@pytest.mark.parametrize("cell", ["flmr_exact_burst", "preflmr_hier_burst"])
def test_serve_control_fails(cell):
    """The reference in TF32 put in the program's place (on the CPU, each
    product's operands rounded to TF32) fails the cell's limits."""
    from portbench.cells import flmr_serve
    from portbench.spec import Cell
    c = Cell(cell, overrides=_tiny.overrides(cell))
    numbers = flmr_serve.controls(c, 21, torch.device("cpu"), False)["tf32"]
    assert not judge.passed(judge.with_limits(numbers,
                                              c.work["check"]["limits"]))


def test_train_controls_fail():
    from portbench.cells import flmr_train
    from portbench.spec import Cell
    c = Cell("flmr_train", overrides=_tiny.overrides("flmr_train"))
    for name, numbers in flmr_train.controls(
            c, 21, torch.device("cpu"), False).items():
        assert not judge.passed(judge.with_limits(
            numbers, c.work["check"]["limits"])), name


@pytest.mark.parametrize("cell", ["flmr_exact_burst", "flmr_train"])
def test_control_reads_the_program(cell, monkeypatch):
    """--program reads the program's own numbers beside the controls', and
    a sound program passes the cell's limits."""
    from portbench.cells import flmr_serve
    from portbench.spec import Cell, cell_module
    monkeypatch.setattr(flmr_serve, "PROGRAM_WINDOW_S", 1.0)
    c = Cell(cell, overrides=_tiny.overrides(cell))
    rows = cell_module(c).controls(c, 23, torch.device("cpu"), True)
    assert judge.passed(judge.with_limits(rows["program"],
                                          c.work["check"]["limits"]))
    assert not judge.passed(judge.with_limits(rows["tf32"],
                                              c.work["check"]["limits"]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card's machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tf32_control_fails_on_card(card):
    """On the card the control's TF32 is the tensor cores' own."""
    from portbench.cells import flmr_serve
    from portbench.spec import Cell
    c = Cell("flmr_exact_burst", overrides=_tiny.overrides(
        "flmr_exact_burst"))
    numbers = flmr_serve.controls(c, 21, card, False)["tf32"]
    assert not judge.passed(judge.with_limits(numbers,
                                              c.work["check"]["limits"]))
